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
   f64 and f32 (bars: normwise relative error 1e-9 and 1e-3,
   NaN-strict), then at the main paths' shapes in f32, where the kernels
   are also timed (CUDA events) beside their bounds; K1's warp kernel
   (``k1_kernels``: a group of warps per model) held ``torch.equal`` to the block
   kernel it replaced (one block per model, kept as its oracle) in every
   mode — carry over k steps and over one, ``bounds``, ``store`` — f64
   and f32 on ``K1_CASES`` (B = 1, 3, 133; T = 1, seg - 1, seg, 4 seg +
   5; an all-masked step, degraded steps, the serving bucket's padding,
   N = 40 and 45; each launch shape on B = 133; the widest buckets of
   eights the block kernel takes, (88, 96) f32 and (64, 72) f64), at the
   flagship fleet
   (512 models, T = 5,000, seg 128) and the serving bucket (512 models,
   k = 1), the block kernel held to the plain version; both timed
   alternately at B = 512, 64, 8, 1 (``bounds``), the serving update
   and ``store`` at B = 512, beside ``k1_cost``'s bound; K1/K2 (serving),
   K3/K4 (fit); K3's chain kernel (``k3_bitwise``: a chain warp and
   update warps a lane) held ``torch.equal`` to the warp kernel it
   replaced (one warp per lane, kept as its oracle), f64 and f32, on
   ``K3_CASES`` (the lanes cases, a NaN reading, seg past T, two and
   three factors, a dense Z, B = 1, 8, 64, 512), past the resident
   four-warp blocks, with three update warps and with none, and at the widest
   bucket, both timed alternately at the line search's trial pass and at
   B = 512, 64, 8, 1 with boundaries (T = 5,000, seg = 100) beside
   ``k3_cost``'s bound (``k3_times``); K4's ring kernel (``k4_bitwise``: replay warps filling
   a ring of segment records for its sweep warps) held ``torch.equal`` to
   the warp kernel it replaced (one warp per lane, kept as its oracle),
   f64 and f32, on ``K4_CASES`` (the lanes cases, a NaN reading, seg
   past T, B = 1, 8, 64, 512), past the resident ring blocks, at forced
   ring shapes and at the widest buckets that stage two records and
   one, both timed alternately at B = 512, 64, 8, 1 (T = 5,000, seg =
   100) beside ``k4_cost``'s bound (``k4_times``), and both held to the
   plain version on a known gap (``K4_UNIT_ROOT_GAP``); K5/K6/K7
   (products), K6's ``store`` mode and K8 (the
   single model's stored filter and RTS smoother: one lane, 16 lanes of
   path draws, and a step whose predicted covariance is made indefinite,
   which K8 must degrade to its filtered moments), K9 and K10 (the
   square-root engine's filter — store, carry only, from a given carry —
   and factored smoother, with and without the covariance: one lane, 16
   lanes, the serving bucket of 512 slots at k = 1, with masked steps, a
   fully masked series and an observed slot with r < 0, which must book
   detf = +inf and pass the state through); the lanes and square-root
   kernels are held against their plain versions (a Python loop over
   steps) at full width over the first ``T_CMP`` = 120 steps and timed
   at the full T; then the square-root engine's f32 contract
   (``tests/test_precision.py``'s recipe, copied): K9's f32 deviance
   within 2e-6 of the CPU f64 one in all four alpha regimes,
   near-unit-root included, finite f32 factors and a final posterior
   that passes ``posterior_fault(psd_tol=0)``, K3's f32 error beside it;
   then the batch-layout adjoint (``adjoint_kernels``): K11 against its
   plain version over each engine's segment boundaries (K1 ``bounds``,
   K9 ``bounds``, K3 ``keep_bounds``; a model observing an r < 0 slot
   and a fully masked step) in f64 and f32 and at the flagship shape
   over ADJ_T_CMP = 300 steps; K1 and K9 ``bounds`` bit for bit their carry
   instantiations, each boundary the carry-only run to that point; the
   anchored adjoint from a non-triangular anchor (its value the score of
   ``sqrt_filter_append``, its gradient the CPU f64 one's); K11's f64
   gradient against central differences of the K1 deviance (rel 1e-6);
   K11 and both ``bounds`` modes timed at the flagship shape; then the
   serving path's input defences (``gate_kernels``): K12 (the gated
   sequential update) in each policy, K9's gated instantiation and K13
   (the detector) against their plain versions on the flagship bucket
   (512 models, (24, 32)) with spikes on known slots and an armed mix
   (f64 and f32, verdicts and alarm counts equal), K12 armed but never
   tripping bit for bit K12 ``off`` and gated K9 never tripping bit for
   bit K9 from the given carry, K1's ``store`` bit for bit its history
   pass at every step (16 models; the flagship fleet at T = 5,000 for
   the last step, the terms and 16 models' every step), each timed at
   the main path's shapes beside its bound; then the robust serving
   updates (``robust_kernels``): K12's and K9's robust modes against
   their plain versions for each likelihood (censored at rails 5% of the
   readings reach, quantized on a 0.1 grid, Student-t with 10-sd spikes
   on 32 cells at scale 0.5) on the flagship bucket at k = 1 and k = 4,
   f64 and f32 (normwise 1e-9 / 1e-3, NaN-strict, equal flagged sets;
   verdicts and iterations equal in f64, within 0.5% of the flagged
   slots in f32), an armed mix; disarmed, and censored with nothing
   railed, each is K12 ``off`` or K9 from the given carry bit for bit,
   kernel and plain; a reading at a rail moves its slot only toward the
   rail's side; the Student-t solves at the default scale 0.05
   reported; each mode timed at B = 512, k = 1 beside its bound; then
   bounded-cost serving (``steady_kernels``): K14 (the frozen-gain
   steady append) in every policy and form against its plain version
   on the flagship bucket (B = 512, k = 1 and 4, spikes, masked cells,
   an armed mix; f64 and f32, broke and verdicts equal), K15 (the DARE
   solve and the frozen gains) in f64 on the flagship fleet's 512
   models and the four alpha regimes of the precision panel (1e-9, the
   DARE residual within 1e-10 of |P|), in f32 on the flagship models
   with its f32-vs-f64 error reported per regime, K9 ``store`` from a
   given non-triangular carry against its plain version and bit for
   bit its own full store's continuation; K14 timed at B = 512, k = 1
   in f32 per policy and form, K15 in f64 for 1 and 512 models;
   then the state arena (``arena_kernels``): K16 (the exact arena update
   fused with the integrity gate, the detection tail and the masked
   in-place scatter; its joint, sequential/gated/robust and square-root
   families), K17 (the frozen-gain arena update) and K18 (the arena
   forecast) against their plain versions on an arena of 1,024
   flagship rows with 512 dispatched, k = 1, f64 and f32 (normwise
   1e-9 / 1e-3 over the accepted rows, NaN-strict; ok, verdicts,
   counts, conv and applied equal): a NaN row and a non-PSD covariance
   row rejected with their rows bit-identical, unnamed rows
   bit-identical, armed and unarmed rows, a masked cell and a fully
   masked row, K17's frozen rows beside broken ones; each family timed
   in f32 beside its bound and its plain version; then the
   associative-scan engines (``pkalman_kernels``): K19/K20 (covariance
   filter and smoother) and K21/K22 (square-root) against their plain
   versions on the same chunks, 16 flagship models over 400 steps in
   chunks of 64 (a ragged tail), two all-missing steps, the last model
   observing a slot with r < 0 (+inf terms on both sides), with and
   without the stored moments, f64 and f32 (factors through S S'); each
   timed in f32 at the automatic chunk length beside its sequential
   twin on the same inputs (K1 ``store`` + K8, K9 ``store`` + K10) at
   one flagship model, 512 flagship models and the long-context model
   (8 series, 1 factor, T = 32,768), the timed launches' outputs held to
   the plain version on the same inputs (models 0-15 of the 512, over
   the filters' first and the smoothers' last 1,000 steps); then
   K19/K20's sharded modes (``sharded_scan_kernels``): ``total``,
   ``carry`` and ``prefix`` against their plain versions on 16 flagship
   models in 4 shards of 100 steps (chunks of 16, a ragged tail), f64 and
   f32, each timed at a middle shard of the long-context and of one
   flagship model beside its bound and its plain version;
4. main path — a 512-model flagship fleet (20 series, 1 factor, 5,000
   steps, 30% missing, f32) filtered by the port's ``kalman_filter`` and
   served by ``MetranService``: forecasts, 10 update rounds, forecasts,
   then threaded synchronous calls; the launch counters must show the
   path went through both kernels, and 8 models are recomputed in f64 on
   the CPU with the plain versions; then the same on the square-root
   engine (history pass ``sqrt_kalman_filter``, K9; states carrying
   factors; ``ModelRegistry(engine="sqrt")`` updating through K9 from
   the stacked factors; 4 models recomputed), and both engines' dispatch
   medians side by side; then the gated serving path (``gated_serving``,
   per engine): ``ModelRegistry(engine=...)`` for ``"joint"``,
   ``"sequential"`` and ``"sqrt"`` holding the 512 flagship posteriors
   after their history pass, and ``MetranService(registry,
   gate=GateSpec(policy="reject"), detect=DetectSpec(enabled=True))``
   assimilating 12 rows of the fleet's own continuation with spikes on
   known (model, slot) cells, a level shift on one series, a poisoned
   model and a cold one; the armed spikes must be flagged, the cold
   model disarmed, the poisoned model's breaker open after 5 failures
   while every other slot of the same launches commits (and
   ``health()`` name it), the shift raise a changepoint in
   ``anomalies()`` and an ``alerts()`` entry, each dispatch launch one
   update kernel (K12, or gated K9) and one K13, and 16 models' flagged
   counts equal a CPU f64 replay through the plain versions; 8 threads
   then make synchronous calls; the same with ``huber`` and ``inflate``
   on the joint registry (6 rounds, no threads); then the robust
   serving path (``robust_serving``): ``MetranService(registry,
   robust=RobustSpec(likelihood=...))`` on the flagship posteriors with
   the fleet's continuation as the sensor reports it — censored on the
   joint registry with detection armed and 8 sync threads, censored on
   ``"sqrt"`` (12 rounds each), huber_t on joint and quantized on
   ``"sqrt"`` (6 rounds each); one robust launch (+ K13) per dispatch,
   every flag the data call for booked, the cold model disarmed, 16
   models replayed on the CPU in f32 (1e-3, the same non-converged
   solves) and f64 (1e-2), a rail probe (censored) and the spikes'
   bounded influence (huber_t); then steady-state serving
   (``steady_serving``): ``MetranService(steady=SteadySpec(tol=1e-4,
   min_seen=256))`` and its exact twin on the flagship fleet after a
   fully observed 400-step history, 12 paired, interleaved k = 1 rounds
   on the joint registry with ``GateSpec("reject", nsigma=12)`` and
   detection and on ``"sqrt"`` ungated: the models freeze (K15), frozen
   dispatches are one K14 launch (+ one K13), the mean deviation within
   2e-3; NaN cells on 8 frozen models, 30-sigma spikes on 8 others
   (they thaw through the gate; ungated they stay frozen) and an
   external put thaw, replay and match their twins; 64 models in f64 at
   tol 1e-9 (bar 1e-8); the dispatch ratio reported; then fixed-lag
   smoothing (``fixed_lag``): ``fixed_lag_smooth`` bit for bit the full
   square-root filter + smoother's last 64 steps on one flagship model
   (f64, f32), and ``MetranService(ModelRegistry(engine="sqrt"),
   fixed_lag=16)`` over 24 rounds on 32 models, every ``smoothed()``
   window held to the card's full filter + smoother over the same rows
   (1e-5, bitwise reported), its wall and one tracker advance timed;
   then the state arena (``arena_serving``): 512 flagship models (f32)
   after a history pass, each run on a per-request arena service
   (``ModelRegistry(arena=True)``, 1,024 rows), a bulk arena service
   (``update_batch``/``forecast_batch``) and a dict service holding the
   same states and taking the same rows, rounds paired and rotated —
   joint with ``GateSpec("reject")`` and detection, joint robust
   censored with detection, sqrt ungated (5 rounds each), steady
   (``SteadySpec(tol=1e-4, min_seen=256)``) on joint gated and on sqrt
   after a fully observed 400-step history (8 rounds): equal acks and
   failures round by round, a poisoned model failing alone with its row
   unchanged, the arena's posteriors and forecasts within rtol 2e-5 /
   atol 1e-6 of the dict's (bulk bit for bit the per-request arena),
   the booked verdicts, robust outcomes, detection and steady
   transitions equal, per run the launches by kernel and the three
   dispatch medians; a 64-row registry taking 96 models (eviction,
   spill, reload, each served again and equal to a dict twin), and a
   ``close()`` that spills for a bit-for-bit warm restart from disk;
5. fit path — the same flagship fleet (its own seed) packed with
   ``pack_fleet`` and fitted by ``fit_fleet(layout="lanes")`` under the
   JAX bench's fit settings (autocorrelation init, ``remat_seg=100``,
   ``tol=0.05``, ``stall_tol=1e-3``, 4 line-search trials,
   ``maxiter=60``, ``chunk=8``); the launch counters must show K3 and K4,
   every lane must end finite and no worse than it started, and 8 lanes
   are recomputed in f64 on the CPU with the plain versions; then
   ``fleet_stderr(method="lanes-fd")`` of the 512 fitted models (B * 2P
   = 21,504 lanes over one data copy through the lane map), 4 of them
   recomputed in f64 in a worker process (checked after phase 7);
5a. mesh path (``mesh_path``) — a virtual mesh of 4 devices, all the
   card: ``sequence_sharded_filter`` (K19/K20 ``total`` -> ``carry`` ->
   ``prefix``) on the long-context and one flagship model within 1e-5 of
   the unsharded K19/K20 and timed beside them; ``fit_fleet(layout=
   "lanes", mesh=)`` on phase 5's fleet and start against phase 5's fit at
   the JAX bars; a 16-model batch fit with and without the mesh; a gated,
   detecting ``ModelRegistry(arena=True, arena_mesh=4)`` bit for bit an
   ``arena_mesh=0`` one over 3 rounds, a bulk tick and forecasts; a real
   mesh too where the host has more cards; every mode must have run;
5b. batch fit — the slice's path: ``fit_fleet(fleet, p0=...)`` with the
   JAX defaults (``layout="batch"``, ``engine="joint"``, the gradient
   through K1 ``bounds`` + K11, optax's zoom-line-search L-BFGS) on phase
   5's fleet, ``maxiter=60, tol=0.05, stall_tol=1e-3``: wall, fits/s,
   iterations, converged/stalled fractions, objective calls, the K1 and
   K11 shares; every lane finite, no worse than its start, converged at
   least as often as the lanes fit, and each model's deviance within
   GAP_BAR = 1e-4 (relative) of the lanes fit's; the launch counts are
   the fit's own; 8 models' f32 value and gradient held to the CPU
   f64 plain path over ADJ_T_CMP steps (1e-4, 1e-3); then the square-root
   engine's batch fit on 16 models (K9 ``bounds`` + K11) and
   ``JaxSolve``'s fit in f64 on the example on the card default
   ``"sqrt"`` (K9 ``bounds`` + K11) held to the golden fit (rel 1e-6 /
   abs 1e-4, parameters rtol 2e-2); the counters must show K1, K9 and
   K11; the path's launches are the three fits' own, not the 8-model
   check's;
6. products path — the post-fit products of the fitted fleet under the
   JAX bench's product settings (``fleet_simulate`` smoothed and
   filtered, ``fleet_decompose``, ``fleet_innovations(warmup=50)`` and
   ``fleet_whiteness``, ``fleet_forecast(steps=14)``,
   ``fleet_sample(n_draws=4)``), one dispatch each, timed; the launch
   counters must show K3, K5, K6, K7 and K2; outputs must be finite
   (innovations NaN exactly where masked or before the warmup),
   variances non-negative and draws through every observed entry; 4
   models (2 for the sample, with the card's normals) are recomputed in
   f64 on the CPU with the plain versions, in worker processes while the
   card runs;
7. Metran path — the single-model API, ``Metran(series)`` on the card:
   the example (5 series, 6,255 days) in f64 (``METRAN_TPU_X64=1``) on
   ``engine="sequential"`` solved by the card's default ``LanesSolve``
   and held to the golden fit (``obj_func`` rel 1e-5, ``optimal`` rtol
   1e-3, finite stderr), the golden rows and the masked 1997-08-28
   value; the same example and table on the card's default engine,
   ``"sqrt"``, held to the golden rows and to the sequential products
   within 1e-9; the example in f32 (the deviance within rtol 1e-3 of
   the golden) and one flagship model (20 series, 5,000 days, 30%
   missing) in f32, both on the default ``"sqrt"``; each with its
   products (states, simulations, decomposition, innovations and
   whiteness, a 14-step forecast, 16 path draws, the serving state)
   timed, and those of the two f32 models held to CPU f64 recomputes at
   the card's fitted tables (worker processes, ≤ 1e-3; the deviance
   ≤ 1e-4); the launch counters must show K3, K4, K6, K7, K8, K9, K10
   and K2;
7b. parallel path — the associative-scan engines through ``Metran``:
   the example in f64 on ``engine="parallel"`` and ``"sqrt_parallel"``
   at phase 7's fitted f64 table (the golden rows, and phase 7's
   sequential products within 1e-9), one flagship model in f32 on each,
   solved by ``LanesSolve``, every product held to CPU f64 recomputes
   (1e-3; the fit's and the engine's own deviance 1e-4); then a
   ``MetranService`` on ``ModelRegistry(engine="sqrt_parallel")``
   serving four copies of the ``sqrt_parallel`` model's state for four
   update rounds and a 14-step forecast, bit for bit an ``engine="sqrt"``
   registry's; the counters must show K19/K20 and K21/K22, the draws on
   K1 ``store`` + K8 and K9 + K10;
8. the JAX defaults the port now shares (``c2_defaults``), on the f64
   example: ``innovations`` (K1 ``store``), ``sample_states`` (K7, K1
   ``store``, K8) and ``filter_append`` (K12 ``off``), each held to the
   sequential engine's within 1e-9.

No path may launch an oracle (K1's and K9's block kernels, K3's and
K4's warp kernels: their own launch counters, read around the path
phases).  Every phase also prints its wall time
(``{"phase_wall": ..., "wall_s": ...}``).  The line before the last is ``nvidia-smi``'s ``name, power.limit``; the
line before that the ``{"kernels": [...]}`` summary; the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import multiprocessing
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor
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
# the JAX bench's product settings (bench.py:565-578)
PRODUCTS = dict(seg=100, warmup=50, n_draws=4, steps=FORECAST_STEPS)
CPU_MODELS = 4  # fitted models the products phase recomputes on the CPU
LS_TRIALS = 4  # the grid line search's trial points per iteration
T_CMP = 120  # steps of the full-width kernel-vs-plain comparisons of
#              the lanes and square-root kernels (their plain versions
#              loop over steps; cut from 1,000 when the batch-layout fit
#              joined the run, from 400 when K4's oracle phase did, from
#              250 when it grew and from 150 when K3's did, to keep the
#              phases near 850 s; 120 keeps a second, ragged segment at
#              seg = 100); K1's history pass, on the batch fit's path, is
#              compared at the full T
ADJ_T_CMP = 300  # the same for K11 and the batch fit's CPU recompute
#                  (cut from 1,000, 600 and 400 with T_CMP)
DEVICE = "cuda"  # the card the lanes and fit phases run on

# H100 SXM peaks (NVIDIA data sheet; dense, no sparsity)
PEAK_BYTES_S = 3.35e12
# ``float32``/``float64`` outside the tensor cores; ``float64_tensor`` the
# f64 tensor cores (DMMA, full IEEE f64), for matrix products
PEAK_FLOPS_S = {"float32": 67e12, "float64": 34e12, "float64_tensor": 67e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(phase, *args, **kw):
    """Run one phase; print its wall time on a line of its own."""
    t0 = time.perf_counter()
    out = phase(*args, **kw)
    emit({"phase_wall": phase.__name__.removeprefix("phase_"),
          "wall_s": time.perf_counter() - t0})
    return out


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


def row_errs(got, want):
    """Per-row relative errors: for each row along the first axis,
    ``max|got - want|`` over its finite entries divided by that row's own
    ``max|want|``, floored at the median row's scale (a row of zeros is
    held at the field's ordinary scale, not at 1e-300).  One outlier row
    with huge values thus sets no bar for the ordinary rows, which a
    normwise error over the whole tensor would.  Returns the (rows,)
    errors, NaN where a row has no finite entry, or None on a non-finite
    mismatch (see :func:`_nonfinite_match`)."""
    import torch

    got, want = got.double(), want.double()
    if not _nonfinite_match(got, want):
        return None
    w = want.reshape(want.shape[0] if want.dim() else 1, -1)
    g = got.reshape(w.shape)
    fin = torch.isfinite(w)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    diff = torch.where(fin, g - w, zero).abs().amax(1)
    scale = torch.where(fin, w, zero).abs().amax(1)
    has = fin.any(1)
    if not has.any():
        return torch.full_like(scale, float("nan"))
    floor = scale[has].median().clamp_min(1e-300)
    errs = diff / torch.maximum(scale, floor)
    return torch.where(has, errs, torch.full_like(errs, float("nan")))


def row_rel_err(got, want) -> float:
    """The largest of :func:`row_errs` (infinite on a non-finite
    mismatch, 0 when nothing is finite)."""
    errs = row_errs(got, want)
    if errs is None:
        return float("inf")
    errs = errs[~errs.isnan()]
    return float(errs.max()) if errs.numel() else 0.0


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


def _proj_ops(big_n, k):
    """The least operations of one step's projections from Z = [I | L]:
    per series ``z_i.m`` on its K+1 nonzeros and ``z_i'C z_i`` on the
    (K+1)x(K+1) block (symmetric), and the clip."""
    return big_n * (2 * (k + 1) + (k + 1) * (k + 2) + 1)


def _lanes_bytes(lanes, n, big_n, d_steps, itemsize):
    """Bytes of a lanes launch's constants, its data (``d_steps`` data
    lane steps of y and mask) and its lane map."""
    return (lanes * (2 * n + big_n * n + big_n) * itemsize
            + d_steps * big_n * (itemsize + 1) + 4 * lanes)


def k5_cost(z, lane_map, count, data_shape, seg, want_cov, itemsize):
    """Bytes the K5 call must move (the lane constants, data, lane map and
    K3's boundaries read once; m_s, Z m_s and the variances written once)
    and the least operations: the replay (:func:`_filter_ops`, the
    boundaries are all it gets) and per observed slot ``k = d/f``,
    ``k.r`` and the r update on z_i's K+1 nonzeros; with the covariance
    ``N k`` on N's upper half, ``k'N k`` and the rank-2 update on the
    rows and columns of z_i's nonzeros.  Per step ``m_s = m_p + P_p r``
    (P_p symmetric), ``Z m_s``, and with the covariance the projections
    of P_p, ``w_i = P_p z_i``, ``w_i'N w_i`` (upper half), the clip and
    the transition of r and N (upper half)."""
    lanes, n, big_n, k, t_steps, n_seg, obs = _lanes_shape(
        z, lane_map, count, seg)
    nbytes = (_lanes_bytes(lanes, n, big_n, data_shape[0] * t_steps,
                           itemsize)
              + lanes * n_seg * (n + n * n) * itemsize
              + lanes * t_steps * (n + 2 * big_n) * itemsize)
    half = n * (n + 1) / 2
    per_obs = n + 2 * n + 2 * (k + 1) + 2
    per_step = n * (n + 1) + big_n * 2 * (k + 1) + n
    if want_cov:
        per_obs += 2 * half + 2 * n + 2 + 4 * n * (k + 1)
        per_step += (_proj_ops(big_n, k) + big_n * (2 * n * (k + 1)
                                                    + 2 * half + n + 2)
                     + half)
    ops = (_filter_ops(n, k, lanes, t_steps, obs) + obs * per_obs
           + lanes * t_steps * per_step)
    return nbytes, ops


def k6_cost(z, lane_map, count, data_shape, mode, t_last, itemsize):
    """Bytes the K6 call must move (the lane constants, lane map, the data
    steps each lane runs and ``t_last`` read once; the mode's outputs
    written once) and the least operations: the forward filter
    (:func:`_filter_ops`) over the steps each lane runs (for ``latch``
    only those before its ``t_last``) and per step the mode's
    projections (:func:`_proj_ops`; the innovations also ``y - Z m_p``
    and ``+ r``; ``store`` copies, no operations)."""
    lanes, n, big_n, k, t_steps, _, obs = _lanes_shape(z, lane_map, count, 1)
    if mode == "latch":
        import torch

        tl = t_last.long()
        stop = torch.where((tl >= 1) & (tl <= t_steps), tl, 0)
        csum = torch.cat([torch.zeros_like(count[:1]),
                          count.cumsum(0)]).double()  # (T+1, D)
        obs = float(csum[stop, lane_map.long()].sum())
        steps = float(stop.sum())
        nbytes = (_lanes_bytes(lanes, n, big_n, steps, itemsize) + 4 * lanes
                  + lanes * (n + n * n) * itemsize)
        half = n * (n + 1) / 2
        ops = (_filter_ops(n, k, lanes, 0, obs)
               + steps * (n + half + n))  # the predicts actually run
        return nbytes, ops
    outs = {"project": n + 2 * big_n, "innovations": 2 * big_n,
            "store": 2 * n + 2 * n * n + 2}[mode]
    nbytes = (_lanes_bytes(lanes, n, big_n, data_shape[0] * t_steps,
                           itemsize)
              + lanes * t_steps * outs * itemsize)
    per_step = {"project": _proj_ops(big_n, k),
                "innovations": _proj_ops(big_n, k) + 2 * big_n,
                "store": 0}[mode]
    return nbytes, (_filter_ops(n, k, lanes, t_steps, obs)
                    + lanes * t_steps * per_step)


def k7_cost(z, r, t_steps, itemsize):
    """Bytes the K7 call must move (the lane constants and the normals
    read once, the path and its pseudo-observations written once) and the
    least operations: ``sqrt(max(q, 0))`` once per lane, per step ``phi
    x + s w`` and ``Z x`` on each row's K+1 nonzeros, and the noise term
    only for the slots with ``r > 0``."""
    big_n, n, lanes = z.shape
    k = n - big_n
    nbytes = (lanes * (2 * n + big_n * n + big_n) * itemsize
              + lanes * (n + t_steps * (n + big_n)) * itemsize
              + lanes * t_steps * (n + big_n) * itemsize)
    noisy = float((r > 0).sum())
    ops = (2 * n * lanes + lanes * t_steps * (3 * n + big_n * (2 * k + 1))
           + noisy * (2 + 2 * t_steps))
    return nbytes, ops


def k8_cost(cov_p, want_cov, itemsize):
    """Bytes the K8 call must move (phi, and the stored m_f, P_f, m_p,
    P_p read once; m_s and, with ``want_cov``, C_s written once) and the
    least operations this run's data needs: per step below T - 1 the
    Cholesky of P_p (n^3/3); where it succeeds (counted on these inputs
    with ``torch.linalg.cholesky_ex``), G = P_f diag(phi) P_p^-1 by two
    triangular solves per row (2 n^3), G (m_s' - m_p) (2 n^2),
    C_s' - P_p (n^2), G D (2 n^3), (G D) G' on its upper half (n^3) and
    + P_f (n^2)."""
    import torch

    lanes, t_steps, n = cov_p.shape[:3]
    steps = lanes * max(t_steps - 1, 0)
    ok = float((torch.linalg.cholesky_ex(cov_p[:, 1:])[1] == 0).sum())
    nbytes = (lanes * n + 2 * lanes * t_steps * (n + n * n)
              + lanes * t_steps * (n + (n * n if want_cov else 0))
              ) * itemsize
    ops = steps * n**3 / 3 + ok * (5 * n**3 + 5 * n * n)
    return nbytes, ops


def _house_ops(below, trailing):
    """Operations of one Householder stage: the norm of ``below``
    entries under the diagonal, the reflector, and its application
    (a dot product and an update over ``below + 1`` rows) to
    ``trailing`` columns."""
    return 2 * below + 4 + trailing * 4 * (below + 1)


def _sqrt_step_ops(n, k, o):
    """The least operations of one square-root filter step with ``o``
    observed slots, Z = [I | L] with K = ``k`` factors: the predict
    (``phi o m``, ``phi o S`` on the lower triangle, and the QR of
    ``[(phi o S)' ; diag(sqrt q)]`` whose column j has only rows j and
    n..n+j to reflect); with observations, ``v`` and ``Z_o S_p`` on the
    K+1 nonzeros of each row (S_p lower), the QR of the compact
    pre-array (observed column i: rows i and the n state rows; state
    column j: the n - 1 - j rows under it), ``w`` by forward
    substitution, ``m_f``, sigma and the o logarithms of detf."""
    predict = n + n * (n + 1) / 2 + sum(
        _house_ops(j + 1, n - 1 - j) for j in range(n))
    if o == 0:
        return predict
    width = o + n
    update = (o * 2 * (k + 1) + o * 2 * (k + 1) * n
              + sum(_house_ops(n, width - 1 - c) for c in range(o))
              + sum(_house_ops(n - 1 - j, n - 1 - j) for j in range(n))
              + o * o + 2 * o * n + 2 * o + o)
    return predict + update


def k9_cost(z, mask, lane_map, store, given, itemsize):
    """Bytes the K9 call must move (the lane constants, the data lanes'
    y and mask, the lane map and a given carry read once; the store's
    per-step moments, or the per-step terms and the final carry, written
    once) and the least operations this run's data needs
    (:func:`_sqrt_step_ops` at each lane step's own observed count)."""
    import collections

    big_n, n, lanes = z.shape
    d_lanes, t_steps = mask.shape[:2]
    nbytes = ((lanes * (2 * n + big_n * n + big_n)) * itemsize
              + d_lanes * t_steps * big_n * (itemsize + 1) + 4 * lanes)
    if given:
        nbytes += lanes * (n + n * n) * itemsize
    if store:
        nbytes += lanes * t_steps * (2 * n + 2 * n * n + 2) * itemsize
    else:
        nbytes += (lanes * 2 * t_steps + lanes * (n + n * n)) * itemsize
    obs = mask.sum(-1)[lane_map.long()].flatten().tolist()
    ops = sum(c * _sqrt_step_ops(n, n - big_n, o)
              for o, c in collections.Counter(obs).items())
    return nbytes, ops


def k10_cost(chol_p, want_cov, itemsize):
    """Bytes the K10 call must move (phi, q and the stored m_f, S_f, m_p,
    S_p read once; m_s and, with ``want_cov``, S_s written once) and the
    least operations this run's data needs: per step below T - 1 where
    ``S_p`` is usable (counted on these inputs), ``P_f = S_f S_f'`` on
    its upper half (S_f lower), G by two triangular solves per row,
    ``m_s``; with the covariance ``(I - G Phi) S_f`` and ``G S_s'`` (both
    factors lower), ``G Q^1/2`` and the QR of the dense 3n x n stack."""
    import torch

    lanes, t_steps, n = chol_p.shape[:3]
    nxt = chol_p[:, 1:]
    diag = torch.diagonal(nxt, 0, -2, -1)
    ok = float(((diag > 0).all(-1)
                & torch.isfinite(nxt).all(-1).all(-1)).sum())
    nbytes = (2 * lanes * n + 2 * lanes * t_steps * (n + n * n)
              + lanes * t_steps * (n + (n * n if want_cov else 0))
              ) * itemsize
    per = n**3 / 3 + n * (2 * n * n + n) + 2 * n * n + n
    if want_cov:
        per += (n * n + n**3 + n * n + n * n + n**3
                + sum(_house_ops(3 * n - 1 - j, n - 1 - j)
                      for j in range(n)))
    return nbytes, ok * per


def _adjoint_step_ops(n, k, o):
    """The least operations of one step of K11 with ``o`` observed slots,
    Z = [I | L] with K = ``k`` factors (each row of Z_o has k + 1
    nonzeros, nnz(Z_o) = o (k + 1)): the replay's predict (``phi o m``,
    ``(phi phi') o P + q`` on the upper half), ``v``, ``P_p Z_o'``, F on
    its upper half, its Cholesky, the solves for ``K'`` (two per column),
    ``e`` and ``L^-1 Z_o`` (one per column), ``m_f`` and ``P_f`` (upper
    half); the sweep's ``w``, ``K'u``, ``A'u``, ``S K``, ``(S K) Z_o``,
    ``K' SA``, ``Z_o' (K' SA)``, ``(L^-1 Z_o)'(L^-1 Z_o)`` on its upper
    half, the assembly of ``S_p`` and ``u_p``; then the predict's
    adjoint (``S_p o P``, two products with phi, ``S o (phi phi')``)."""
    half = n * (n + 1) / 2
    predict = n + 2 * half
    adjoint = n * n + 4 * n * n + 2 * n * n + 2 * n
    if o == 0:
        return predict + adjoint
    nnz = o * (k + 1)
    replay = (2 * nnz + 2 * nnz * n + (o + 1) * nnz + o**3 / 3
              + 2 * o * o * n + 2 * o * o + o * o * n + 2 * o * n
              + 2 * o * half)
    sweep = (2 * nnz + 2 * o * n + 2 * nnz + 2 * n * n * o + 2 * nnz * n
             + 2 * o * n * n + 2 * nnz * n + 2 * o * half + 6 * n * n
             + 3 * n)
    return predict + replay + sweep + adjoint


def k11_cost(z, mask, seg, itemsize):
    """Bytes the K11 call must move (phi, q, Z, r, the data, the
    boundaries and the cotangents read once; phibar and qbar written
    once — the replay scratch is the kernel's own) and the least
    operations this run's data needs (:func:`_adjoint_step_ops` at each
    model step's own observed count)."""
    import collections

    b, big_n, n = z.shape
    t_steps = mask.shape[1]
    n_seg = -(-t_steps // seg)
    nbytes = (b * (2 * n + big_n * n + big_n) * itemsize
              + b * t_steps * big_n * (itemsize + 1)
              + b * n_seg * (n + n * n) * itemsize
              + 2 * b * t_steps * itemsize + 2 * b * n * itemsize)
    obs = mask.sum(-1).flatten().tolist()
    ops = sum(c * _adjoint_step_ops(n, n - big_n, o)
              for o, c in collections.Counter(obs).items())
    return nbytes, ops


def bounds_cost(cost, b, n, t_steps, seg, itemsize):
    """A carry-only filter's ``(bytes, operations)`` plus the boundaries
    its bounds instantiation writes: ``(m, P)`` (or ``(m, S)``) at the
    start of each of the ``ceil(T / seg)`` segments."""
    nbytes, ops = cost
    return nbytes + b * -(-t_steps // seg) * (n + n * n) * itemsize, ops


def bound_ms(nbytes, flops, dtype_name):
    """The larger of the bytes' time and the operations' time; ``flops``
    is a count at ``dtype_name``'s rate, or a dict of counts keyed by
    their ``PEAK_FLOPS_S`` rate (products on the tensor cores, the rest
    outside them)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    work = flops if isinstance(flops, dict) else {dtype_name: flops}
    t_ops = sum(v / PEAK_FLOPS_S[k] for k, v in work.items()) * 1e3
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
                      reps=20, warm=2, plain_reps=20, cmp_args=None):
        """Time ``fn`` at ``args``; compare it with ``plain`` (and time
        that) at ``cmp_args``, default ``args``."""
        ms, got = cuda_ms(lambda: fn(*args), reps=reps, warm=warm)
        if cmp_args is not None:
            got = fn(*cmp_args)
        plain_ms, want = cuda_ms(lambda: plain(*(cmp_args or args)),
                                 reps=plain_reps,
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
        if cmp_args is not None:
            times[key]["plain_shape"] = f"the first {T_CMP} steps, once"

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


K1_SEG = 16  # the segment of K1's warp-vs-block cases (short, many segments)
# K1's warp-vs-block cases: (label, models, steps, widths, options); the
# flagship widths unless stated.  ``padded``: the serving bucket (24, 32)
# as the registry pads a flagship model; ``degraded``: model 0 observes a
# slot with r < 0 at a few steps (those steps degrade).  Every case has
# an all-masked step once T > 3.
K1_CASES = (
    ("B=1 T=1", 1, 1, (N_SERIES, N_FACTORS), {}),
    ("B=3 T=seg-1", 3, K1_SEG - 1, (N_SERIES, N_FACTORS), {}),
    ("B=3 T=seg", 3, K1_SEG, (N_SERIES, N_FACTORS), {}),
    ("B=133 T=4 seg+5", 133, 4 * K1_SEG + 5, (N_SERIES, N_FACTORS), {}),
    ("B=3, degraded steps (r < 0)", 3, 2 * K1_SEG + 7,
     (N_SERIES, N_FACTORS), {"degraded": True}),
    ("B=3 N=24 S=32 (the serving bucket)", 3, 2 * K1_SEG + 7,
     (N_SERIES, N_FACTORS), {"padded": True}),
    ("B=3 N=40 S=41", 3, 2 * K1_SEG + 5, (40, 1), {}),
    ("B=2 N=45 S=46", 2, 2 * K1_SEG + 5, (45, 1), {}),
)
# the widest buckets of eights the block kernel (and the joint arena
# update) takes, which the warp kernel must take too: (dtype, label,
# models, steps, (series, factors))
K1_WIDE = (
    ("float32", "B=2 N=88 S=96 (f32's widest bucket)", 2, K1_SEG + 3,
     (88, 8)),
    ("float64", "B=2 N=64 S=72 (f64's widest bucket)", 2, K1_SEG + 3,
     (64, 8)),
)
# K1's warp-kernel shapes (W models a block, G warps a model) forced on
# the B=133 case (partial last blocks)
K1_SHAPES = ((1, 1), (3, 1), (8, 1), (1, 4), (2, 4))


def _k1_case(rng, b, t, widths, dtype, dev, degraded=False, padded=False):
    """K1's arguments for a warp-vs-block case, from a warm non-diagonal
    posterior (``(phi, q, z, r, mean, cov, y, mask)``)."""
    import numpy as np
    import torch

    from metran_tpu_torch.ops import dfm_statespace

    if padded:
        phi, q, z, r, y, mask = padded_inputs(rng, b, t, dtype, dev)
        mask = mask.cpu().numpy()
    else:
        big_n, kf = widths
        phi, q, z, r = dfm_statespace(
            rng.uniform(5, 40, (b, big_n)), rng.uniform(10, 60, (b, kf)),
            rng.uniform(0.3, 0.8, (b, big_n, kf)) / kf, 1.0, device=dev,
            dtype=dtype)
        mask = rng.uniform(size=(b, t, big_n)) > 0.3
        if t > 3:
            mask[:, 3] = False
    r = torch.full_like(r, 0.2)
    if degraded:
        r[0, 2] = -5.0
        mask[0, :, 2] = False
        mask[0, 1:t:3, 2] = True
    y = torch.as_tensor(np.where(mask, rng.normal(size=mask.shape), 0.0),
                        dtype=dtype, device=dev)
    s = phi.shape[1]
    a = rng.normal(size=(b, s, s)) * 0.1
    cov = torch.as_tensor(np.eye(s) + a @ a.transpose(0, 2, 1), dtype=dtype,
                          device=dev)
    mean = torch.as_tensor(rng.normal(size=(b, s)) * 0.1, dtype=dtype,
                           device=dev)
    return (phi, q, z, r, mean, cov, y, torch.as_tensor(mask, device=dev))


def _k1_modes(jf, args, warp):
    """K1's modes on ``args`` through the warp (or the block) kernel:
    carry over all steps and over the first, bounds every K1_SEG steps,
    store."""
    append = (jf.joint_filter_append_kernel if warp
              else jf.joint_filter_append_block)
    store = jf.joint_filter_store_kernel if warp else jf.joint_filter_store_block
    first = (*args[:6], args[6][:, :1].contiguous(),
             args[7][:, :1].contiguous())
    return {"carry": append(*args), "carry k=1": append(*first),
            "bounds": append(*args, bounds_seg=K1_SEG), "store": store(*args)}


def _same(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_k1_kernels():
    """K1's warp kernel bit for bit its block kernel, and both timed.

    The warp kernel (a group of warps per model) computes every entry by the
    block kernel's sequence of operations, so the two must agree by
    ``torch.equal`` in every mode — carry (all steps, and one),
    ``bounds`` and ``store`` — f64 and f32, on K1_CASES (short and
    exact-multiple horizons, more models than one block of any width,
    an all-masked step, degraded steps, the serving bucket's padding,
    N = 40 and 45), on the B=133 case at each launch shape in K1_SHAPES
    forced through the wrapper's chooser, at the flagship fleet (512 models,
    T = 5,000, seg 128) and at the serving bucket (512 models, k = 1 from
    a warm posterior); the block kernel is held to the plain version on
    the cases (f64 1e-9, f32 1e-3, NaN-strict).  Then both kernels timed
    alternately (block, warp, warp, block) at B = 512, 64, 8, 1
    (``bounds``, flagship inputs), the serving update and ``store`` at
    B = 512, each beside ``k1_cost``'s bound."""
    import importlib

    import numpy as np
    import torch

    from metran_tpu_torch.kernels import launches

    from metran_tpu_torch.kernels.build import oracle_launches

    jf = importlib.import_module("metran_tpu_torch.kernels.joint_filter")
    dev = torch.device(DEVICE)
    checks, bitwise = [], []

    def equal(label, dtype, a, b):
        same = {mode: _same(a[mode], b[mode]) for mode in a}
        bitwise.append({"case": label, "dtype": str(dtype).replace(
            "torch.", ""), "bitwise": same})

    for dtype, bar in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        for label, b, t, widths, kw in K1_CASES:
            rng = np.random.default_rng(SEED + 160)
            args = _k1_case(rng, b, t, widths, dtype, dev, **kw)
            before = (launches(), oracle_launches())
            warp = _k1_modes(jf, args, True)
            after = (launches(), oracle_launches())
            block = _k1_modes(jf, args, False)
            torch.cuda.synchronize()
            require(after[0]["joint_filter_append"]
                    - before[0]["joint_filter_append"] == 3
                    and after[0]["joint_filter_store"]
                    - before[0]["joint_filter_store"] == 1
                    and after[1] == before[1],
                    f"K1 {label}: the warp modes' launches")
            equal(label, dtype, warp, block)
            want = joint_filter_plain_modes(jf, args)
            for mode in ("bounds", "store"):
                checks.append(check_entry(
                    "joint_filter_append_block" if mode == "bounds"
                    else "joint_filter_store_block", f"{label}, {mode}",
                    dtype, block[mode], want[mode], bar))
            if b == 133:  # each launch shape, partial last blocks
                chooser = jf.block_shape
                try:
                    for shape in K1_SHAPES:
                        jf.block_shape = lambda *a, shape=shape: shape
                        equal(f"{label}, (W, G)={shape}", dtype,
                              _k1_modes(jf, args, True), block)
                finally:
                    jf.block_shape = chooser
        for name, label, b, t, widths in K1_WIDE:
            if name != str(dtype).replace("torch.", ""):
                continue
            rng = np.random.default_rng(SEED + 161)
            args = _k1_case(rng, b, t, widths, dtype, dev)
            equal(label, dtype, _k1_modes(jf, args, True),
                  _k1_modes(jf, args, False))

    # the flagship fleet (f32) in every mode, and the serving bucket
    rng = np.random.default_rng(SEED + 95)
    ss, y, mask = _adjoint_case(rng, FLEET, T_STEPS, torch.float32, dev)
    n = ss.phi.shape[1]
    m0 = ss.phi.new_zeros((FLEET, n))
    c0 = torch.eye(n, dtype=torch.float32, device=dev).expand(
        FLEET, n, n).contiguous()
    full = (*ss, m0, c0, y, mask)
    flag = {}
    for warp in (True, False):
        append = (jf.joint_filter_append_kernel if warp
                  else jf.joint_filter_append_block)
        flag[warp] = {"bounds": append(*full, bounds_seg=ADJ_SEG),
                      "carry": append(*full)}
    equal(f"B={FLEET} T={T_STEPS} (20,21) seg={ADJ_SEG}", torch.float32,
          flag[True], flag[False])
    del flag
    st = {warp: (jf.joint_filter_store_kernel if warp
                 else jf.joint_filter_store_block)(*full)
          for warp in (True, False)}
    equal(f"B={FLEET} T={T_STEPS} (20,21), store", torch.float32,
          {"store": st[True]}, {"store": st[False]})
    del st
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 3)
    phi, q, z, r, yb, mb = padded_inputs(rng, FLEET, 65, torch.float32, dev)
    s = phi.shape[1]
    warm = jf.joint_filter_append_kernel(
        phi, q, z, r, phi.new_zeros((FLEET, s)),
        torch.eye(s, dtype=phi.dtype, device=dev).expand(
            FLEET, s, s).contiguous(), yb[:, :64], mb[:, :64])
    serve = (phi, q, z, r, warm[0], warm[1], yb[:, 64:].contiguous(),
             mb[:, 64:].contiguous())
    equal(f"B={FLEET} k=1 (24,32), the serving update", torch.float32,
          {"carry": jf.joint_filter_append_kernel(*serve)},
          {"carry": jf.joint_filter_append_block(*serve)})
    # the block kernel against plain at the serving bucket (its time and
    # the plain version's go into the summary)
    block_ms, got = cuda_ms(lambda: jf.joint_filter_append_block(*serve))
    plain_ms, want = cuda_ms(lambda: jf.joint_filter_append_plain(*serve))
    checks.append(check_entry("joint_filter_append_block",
                              f"main path: B={FLEET} k=1 (24,32)",
                              torch.float32, got, want, 1e-3))
    emit({"phase": "k1_bitwise", "checks": bitwise})
    bad = [c for c in bitwise if not all(c["bitwise"].values())]
    require(not bad, f"K1's warp kernel differs from its block kernel: {bad}")

    # both kernels timed, alternating
    def alternate(block_fn, warp_fn, cost, reps=3):
        got = {"block": [], "warp": []}
        for who in ("block", "warp", "warp", "block"):
            ms, _ = cuda_ms(block_fn if who == "block" else warp_fn,
                            reps=reps, warm=1)
            got[who].append(ms)
        bms, bby = bound_ms(*cost, "float32")
        return {"block_ms": got["block"], "warp_ms": got["warp"],
                "speedup": min(got["block"]) / min(got["warp"]),
                "bound_ms": bms, "bound_by": bby}

    timing = {}
    for b in (FLEET, 64, 8, 1):
        part = [a[:b].contiguous() for a in full]
        timing[f"bounds B={b}"] = alternate(
            lambda: jf.joint_filter_append_block(*part, bounds_seg=ADJ_SEG),
            lambda: jf.joint_filter_append_kernel(*part, bounds_seg=ADJ_SEG),
            bounds_cost(k1_cost(part[2], part[1], part[7], 4), b, n, T_STEPS,
                        ADJ_SEG, 4))
        timing[f"bounds B={b}"]["block_shape"] = jf.block_shape(
            b, N_SERIES, n, torch.float32, dev, "bounds")
    timing[f"serving update B={FLEET} k=1 (24,32)"] = alternate(
        lambda: jf.joint_filter_append_block(*serve),
        lambda: jf.joint_filter_append_kernel(*serve),
        k1_cost(z, q, serve[7], 4), reps=20)
    timing[f"store B={FLEET}"] = alternate(
        lambda: jf.joint_filter_store_block(*full),
        lambda: jf.joint_filter_store_kernel(*full),
        store_cost(k1_cost(full[2], full[1], full[7], 4), FLEET, n, T_STEPS,
                   4), reps=2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geometry = {str(dt).replace("torch.", ""): {
        f"{wn}x{ws}": {"model_bytes": jf.model_bytes(wn, ws, dt),
                       "block_kernel_bytes": jf.block_smem_bytes(wn, ws, dt),
                       "four_warp_blocks_per_sm": jf.occupancy(
                           wn, ws, dt, "bounds", 1, jf.MAX_GROUP),
                       "sms": sms}
        for wn, ws in ((N_SERIES, n), BUCKET)}
        for dt in (torch.float32, torch.float64)}
    emit({"phase": "k1_times", "shape": f"(20,21) f32 T={T_STEPS} "
          f"seg={ADJ_SEG}; serving (24,32) k=1", "times": timing,
          "geometry": geometry})
    times = {
        "joint_filter_append_block": {
            "shape": f"B={FLEET} k=1 N=24 S=32 f32 (update dispatch)",
            "ms": block_ms, "plain_ms": plain_ms,
            **{key: timing[f"serving update B={FLEET} k=1 (24,32)"][key]
               for key in ("bound_ms", "bound_by")},
            "bounds_by_batch": {key: {"ms": min(v["block_ms"]),
                                      "bound_ms": v["bound_ms"]}
                                for key, v in timing.items()
                                if key.startswith("bounds")}},
        "k1_warp_vs_block": timing}
    emit({"phase": "k1_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar", "ok")}
        for c in checks]})
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"kernel disagrees with its plain version: {bad}")
    return checks, times


def joint_filter_plain_modes(jf, args):
    """The plain versions of K1's ``bounds`` and ``store`` modes."""
    return {"bounds": jf.joint_filter_append_plain(*args, bounds_seg=K1_SEG),
            "store": jf.joint_filter_store_plain(*args)}


def phase_main_path(engine="joint"):
    """The port's serving path at full width on the card, on the joint
    engine (the history pass and the updates through K1) or the
    square-root engine (both through K9, the states carrying factors);
    returns the launch counts and the dispatch medians."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.ops import (
        chol_outer,
        dfm_statespace,
        filter_append,
        forecast_observation_moments,
        kalman_filter,
        sqrt_filter_append,
        sqrt_kalman_filter,
    )
    from metran_tpu_torch.serve import (
        MetranService,
        ModelRegistry,
        PosteriorState,
    )

    dev = torch.device(DEVICE)
    t_hist = T_STEPS
    rng = np.random.default_rng(SEED)
    y, mask, lds, a_s, a_c = make_workload(rng, FLEET)
    f32 = np.float32
    reset_launches()

    sqrt = engine == "sqrt"
    # 1. history pass: the fleet's posteriors, one K1 (or K9) launch
    ss = dfm_statespace(a_s.astype(f32), a_c.astype(f32), lds.astype(f32),
                        1.0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if sqrt:
        res = sqrt_kalman_filter(ss, y.astype(f32), mask, store=False)
        chols = res.chol_f.cpu().numpy()
        means = res.mean_f.cpu().numpy()
        covs = chol_outer(res.chol_f).cpu().numpy()
    else:
        res = kalman_filter(ss, y.astype(f32), mask, engine="joint",
                            store=False)
        means, covs = res.mean_f.cpu().numpy(), res.cov_f.cpu().numpy()
        chols = [None] * FLEET
    t_history = time.perf_counter() - t0
    n_hist_degraded = int(torch.isinf(res.detf).sum())

    reg = ModelRegistry(root=None, engine=engine)
    names = tuple(f"s{j}" for j in range(N_SERIES))
    for i in range(FLEET):
        reg.put(PosteriorState(
            model_id=f"m{i}", version=0, t_seen=t_hist,
            mean=means[i], cov=covs[i],
            params=np.concatenate([a_s[i], a_c[i]]).astype(f32),
            loadings=lds[i].astype(f32), dt=1.0,
            scaler_mean=np.zeros(N_SERIES, f32),
            scaler_std=np.ones(N_SERIES, f32), names=names, chol=chols[i],
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
        if sqrt:
            require(st.chol is not None and np.all(np.isfinite(st.chol))
                    and np.array_equal(st.cov, st.chol @ st.chol.T),
                    (m, "the committed state lost its factor"))
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
    for kern in ("sqrt_filter" if sqrt else "joint_filter_append",
                 "forecast_moments"):
        require(counts[kern] > 0, f"main path never launched {kern}")

    # models the sync calls left alone (8; 4 on the square-root engine),
    # recomputed in f64 on the CPU with the plain versions
    errs = {"mean": [], "cov": [], "fc_means": [], "fc_vars": []}
    n_sync = len(sync_ids)
    n_cpu = 4 if sqrt else 8
    for i in range(n_sync, FLEET, (FLEET - n_sync) // n_cpu):
        ss_c = dfm_statespace(a_s[i].astype(f32).astype(float),
                              a_c[i].astype(f32).astype(float),
                              lds[i].astype(f32).astype(float), 1.0,
                              device="cpu")
        y_c = y[i].astype(f32).astype(float)
        if sqrt:
            r_c = sqrt_kalman_filter(ss_c, y_c, mask[i], store=False,
                                     device="cpu")
            m_c, s_c = r_c.mean_f, r_c.chol_f
        else:
            r_c = kalman_filter(ss_c, y_c, mask[i], engine="joint",
                                store=False, device="cpu")
            m_c, c_c = r_c.mean_f, r_c.cov_f
        for rows in upd_rows:
            row = rows[i]
            msk = np.isfinite(row)
            if sqrt:
                m_c, s_c, _, _ = sqrt_filter_append(
                    ss_c, m_c, s_c, np.where(msk, row, 0.0), msk,
                    device="cpu")
            else:
                m_c, c_c, _, _ = filter_append(
                    ss_c, m_c, c_c, np.where(msk, row, 0.0), msk,
                    device="cpu")
        if sqrt:
            c_c = chol_outer(s_c)
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

    medians = {"update_dispatch_ms": pct(upd_times, 50) * 1e3,
               "forecast_dispatch_ms": pct(fc_times, 50) * 1e3,
               "sync_update_p50_ms": pct(call_ms["update"], 50),
               "sync_forecast_p50_ms": pct(call_ms["forecast"], 50)}
    emit({
        "phase": "main_path" if not sqrt else "main_path_sqrt",
        "engine": engine, "fleet": FLEET, "t_history": t_hist,
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
        "cpu_f64_models": len(errs["mean"]),
    })
    return counts, medians


def lanes_case(rng, b, t, dtype, dev, n_pad=0, trials=1, unit_root=None,
               gaps=False, factors=N_FACTORS):
    """A lanes launch's inputs from the flagship recipe: ``(phi, q, z, r,
    y, mask, lane_map, count)`` for ``trials`` lanes per data lane (the
    line search's layout), ``n_pad`` padded series slots (masked, zero
    loadings), a fully masked real series and a fully masked step;
    ``unit_root`` = "all" puts every state of lane 0 at alpha = 3e4,
    "factor" its common factors; ``gaps`` also masks the first step and a
    stretch of 20 steps in every other data lane; ``factors`` common
    factors."""
    import numpy as np
    import torch

    from metran_tpu_torch.ops.lanes import lanes_statespace, prepare_data

    y, mask, lds, a_s, a_c = make_workload(rng, b, t=t, k=factors)
    n_obs = N_SERIES + n_pad
    yp = np.zeros((b, t, n_obs))
    mp = np.zeros((b, t, n_obs), bool)
    yp[:, :, :N_SERIES] = y
    mp[:, :, :N_SERIES] = mask
    mp[:, :, 5] = False  # a fully masked real series
    if t > 3:
        mp[:, 3] = False  # a fully masked step
    if gaps:
        mp[:, 0] = False
        mp[1::2, 40:60] = False
    ld = np.zeros((n_obs, factors, b))
    ld[:N_SERIES] = np.transpose(lds, (1, 2, 0))
    alpha = np.ones((n_obs + factors, b)) * 10.0
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


def check_entry(kernel, case, dtype, got, want, bar):
    """One kernel-vs-plain comparison: normwise relative errors of each
    output (NaN-strict), emitted as a ``kernel_check`` line."""
    errs = [rel_err(g, w) for g, w in zip(got, want) if w is not None]
    entry = {
        "kernel": kernel, "case": case,
        "dtype": str(dtype).replace("torch.", ""), "rel_err": errs,
        "bar": bar, "ok": within(errs, bar),
        "max_abs_err": max(abs_err(g, w) for g, w in zip(got, want)
                           if w is not None),
    }
    emit({"phase": "kernel_check", **entry})
    return entry


def short_args(args, t=None):
    """A lanes launch's ``(phi, q, z, r, y, mask, lane_map)`` over the
    first ``t`` (default ``T_CMP``) steps of its data."""
    t = T_CMP if t is None else t
    return [*args[:4], args[4][:, :t], args[5][:, :t], *args[6:]]


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

    def compare(*args):
        checks.append(check_entry(*args))

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

    # the fit path's launches, f32, full width: K3 over K*B trial lanes
    # (no boundaries), K3 over B lanes with boundaries (the value and
    # gradient's forward), K4 over B lanes; held against the plain
    # versions over the first T_CMP steps (the plain versions, a Python
    # loop over steps and slots, take ~5 s per 1,000 steps), timed at the
    # full T
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
    trial_cmp = short_args(trial_args)
    vg_cmp = short_args(vg_args)
    got_trial = lanes_filter(*trial_cmp, seg=seg)
    got_vg = lanes_filter(*vg_cmp, seg=seg, keep_bounds=True)
    plain_ms, want = cuda_ms(
        lambda: lanes_filter_plain(*trial_cmp, seg=seg, keep_bounds=True),
        reps=1, warm=0)
    compare("lanes_filter", f"main path: K*B={LS_TRIALS * FLEET} lanes "
            f"T={T_CMP} N={N_SERIES} f32 (line-search trials)", dtype,
            got_trial[:4], want[:4], 1e-3)
    want_vg = [w[..., :FLEET] for w in want]
    compare("lanes_filter", f"main path: B={FLEET} lanes with boundaries "
            f"T={T_CMP} (value and gradient)", dtype, got_vg, want_vg, 1e-3)
    cot = deviance_cotangents(count[:T_CMP], lane_map[:FLEET])
    adj = (*vg_cmp, seg, got_vg.bounds_mean, got_vg.bounds_cov, *cot)
    got4 = lanes_adjoint(*adj)
    plain4, want4 = cuda_ms(lambda: lanes_adjoint_plain(*adj), reps=1,
                            warm=0)
    compare("lanes_adjoint", f"main path: B={FLEET} T={T_CMP} "
            f"N={N_SERIES} seg={seg} f32 (gradient)", dtype, got4, want4,
            1e-3)
    ms, _ = cuda_ms(lambda: lanes_filter(*trial_args, seg=seg), reps=5,
                    warm=1)
    ms_vg, full_vg = cuda_ms(
        lambda: lanes_filter(*vg_args, seg=seg, keep_bounds=True),
        reps=5, warm=1)
    nb, ops = k3_cost(z, lane_map, count, data_shape, seg, False, 4)
    bms, bby = bound_ms(nb, ops, "float32")
    nb_vg, ops_vg = k3_cost(z[..., :FLEET], lane_map[:FLEET], count,
                            data_shape, seg, True, 4)
    bms_vg, bby_vg = bound_ms(nb_vg, ops_vg, "float32")
    times["lanes_filter"] = {
        "shape": f"K*B={LS_TRIALS * FLEET} T={T_STEPS} N={N_SERIES} "
                 f"n={N_SERIES + N_FACTORS} f32 (line-search trials)",
        "ms": ms, "plain_ms": plain_ms,
        "plain_shape": f"K*B={LS_TRIALS * FLEET} T={T_CMP}, with "
                       "boundaries, once",
        "bound_ms": bms, "bound_by": bby,
        "vg_launch": {"shape": f"B={FLEET} with boundaries, seg={seg}",
                      "ms": ms_vg, "bound_ms": bms_vg, "bound_by": bby_vg},
    }
    cot = deviance_cotangents(count, lane_map[:FLEET])
    adj = (*vg_args, seg, full_vg.bounds_mean, full_vg.bounds_cov, *cot)
    ms4, _ = cuda_ms(lambda: lanes_adjoint(*adj), reps=3, warm=1)
    nb4, ops4 = k4_cost(z[..., :FLEET], lane_map[:FLEET], count, data_shape,
                        seg, 4)
    bms4, bby4 = bound_ms(nb4, ops4, "float32")
    times["lanes_adjoint"] = {
        "shape": f"B={FLEET} T={T_STEPS} N={N_SERIES} seg={seg} f32",
        "ms": ms4, "plain_ms": plain4,
        "plain_shape": f"B={FLEET} T={T_CMP}, once",
        "bound_ms": bms4, "bound_by": bby4,
    }
    emit({"phase": "lanes_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar", "ok")}
        for c in checks], "times": times})
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"kernel disagrees with its plain version: {bad}")
    return checks, times


# K4's ring kernel against its warp kernel: (label, data lanes, steps,
# seg, keywords of lanes_case; "nan": a NaN reading at lane 0, step 2,
# slot 3): the lanes cases of phase_lanes_kernels, a NaN reading (a
# non-finite dvec takes the full row), a seg past T, B = 1, 8, 64, 512
K4_SEG = 100  # the fit's remat_seg (FIT)
K4_CASES = (
    ("padded series (24 slots, 20 real), a masked series and step", 16,
     250, K4_SEG, dict(n_pad=4)),
    ("near-unit-root lane (alpha=3e4)", 16, 250, K4_SEG,
     dict(unit_root="factor")),
    ("lane map, K=4 trials over 16 data lanes", 16, 250, K4_SEG,
     dict(trials=4)),
    ("a NaN reading", 8, 60, 16, dict(nan=True)),
    ("seg past T", 4, 30, 64, {}),
    ("B=1", 1, 333, K4_SEG, {}),
    ("B=8", 8, 205, 50, {}),
    ("B=64", 64, 130, 40, {}),
    ("B=512", FLEET, 120, 50, {}),
)
#: K4's known gap to its plain version in f64 at random cotangents on a
#: lane with every state near a unit root (alpha = 3e4): the warp kernel's
#: and the ring kernel's alike (bit for bit), past the 1e-9 bar of the
#: other cases; the fit's own cotangents stay within 1e-9
K4_UNIT_ROOT_GAP = 1e-8
# forced (R, sweep warps, staged records); two sweep warps stage two
K4_SHAPES = ((1, 1, 0), (2, 2, 2), (3, 1, 2), (4, 1, 0), (1, 2, 2),
             (4, 1, 2), (2, 1, 1), (4, 1, 1))


def _k4_case(rng, d, t, seg, dtype, dev, nan=False, deviance=False, **kw):
    """K4's arguments ``(phi, q, z, r, y, mask, lane_map, seg, bounds_mean,
    bounds_cov, sb, db)`` from :func:`lanes_case`, with K3's boundaries
    and random cotangents (or, with ``deviance``, the deviance's), and
    the data's observed-slot counts."""
    import torch

    from metran_tpu_torch.kernels import lanes_filter

    *args, count = lanes_case(rng, d, t, dtype, dev, **kw)
    if nan:
        args[4][0, 2, 3] = float("nan")
        args[5][0, 2, 3] = True
    fwd = lanes_filter(*args, seg=seg, keep_bounds=True)
    if deviance:
        cot = [c.to(dtype) for c in deviance_cotangents(count, args[6])]
    else:
        cot = torch.as_tensor(rng.normal(size=(2, *fwd.sigma.shape)),
                              dtype=dtype, device=dev)
    return (*args, seg, fwd.bounds_mean, fwd.bounds_cov, cot[0],
            cot[1]), count


def k4_times(kl, dev, batches=(FLEET, 64, 8, 1), reps=1):
    """K4's ring kernel and its warp kernel timed alternately (warp, ring,
    ring, warp) at each of ``batches`` lanes, T = 5,000, seg = 100,
    (20, 21) f32, each pair held bit for bit, beside ``k4_cost``'s bound
    and the shape ``ring_geometry`` chose: ``{"B=b": {...}}``."""
    import numpy as np
    import torch

    timing = {}
    rng = np.random.default_rng(SEED + 21)
    adj, count = _k4_case(rng, max(batches), T_STEPS, K4_SEG, torch.float32,
                          dev)
    data_shape = tuple(adj[4].shape)
    for b in batches:
        part = ([a[..., :b].contiguous() for a in adj[:4]]
                + [adj[4][:b].contiguous(), adj[5][:b].contiguous(),
                   adj[6][:b].contiguous(), K4_SEG]
                + [a[..., :b].contiguous() for a in adj[8:]])
        got, outs = {"warp": [], "ring": []}, {}
        for who in ("warp", "ring", "ring", "warp"):
            fn = (kl.lanes_adjoint_warp_kernel if who == "warp"
                  else kl.lanes_adjoint_kernel)
            ms, outs[who] = cuda_ms(lambda: fn(*part), reps=reps, warm=1)
            got[who].append(ms)
        bms, bby = bound_ms(*k4_cost(part[2], part[6], count[:, :b],
                                     (b,) + data_shape[1:], K4_SEG, 4),
                            "float32")
        timing[f"B={b}"] = {
            "warp_ms": got["warp"], "ring_ms": got["ring"],
            "speedup": min(got["warp"]) / min(got["ring"]),
            "bound_ms": bms, "bound_by": bby,
            "geometry": list(kl.ring_geometry(
                b, T_STEPS, K4_SEG, N_SERIES, N_SERIES + N_FACTORS,
                torch.float32, dev)),
            "bitwise": _same_nan(outs["ring"], outs["warp"])}
    return timing


def phase_k4_kernels():
    """K4's ring kernel bit for bit its warp kernel, and both timed.

    The ring kernel computes every entry by the warp kernel's operations
    in its order, so the two agree by ``torch.equal`` (NaN in the same
    places), f64 and f32, on K4_CASES, past the card's resident ring
    blocks, at forced ring shapes (K4_SHAPES: R replay warps over R + 1
    slots and over R; two records staged with one or two sweep warps,
    one, or none) and at the widest one-factor buckets that stage two records,
    one and none; each case counts the ring kernel's launch under K4's
    name and the warp kernel's apart (``k4_bitwise``).  Then both timed
    alternately (:func:`k4_times`, ``k4_times``); the warp kernel against
    its plain version on the trials case."""
    import importlib

    import numpy as np
    import torch

    from metran_tpu_torch.kernels import launches, lanes_adjoint_plain
    from metran_tpu_torch.kernels.build import oracle_launches

    kl = importlib.import_module("metran_tpu_torch.kernels.lanes")
    dev = torch.device(DEVICE)
    bitwise, checks = [], []

    def both(adj):
        before = (launches(), oracle_launches())
        ring = kl.lanes_adjoint(*adj)
        mid = (launches(), oracle_launches())
        warp = kl.lanes_adjoint_warp_kernel(*adj)
        after = (launches(), oracle_launches())
        torch.cuda.synchronize()
        require(mid[0]["lanes_adjoint"] - before[0]["lanes_adjoint"] == 1
                and mid[1] == before[1] and after[0] == mid[0]
                and after[1]["lanes_adjoint_warp"]
                - mid[1]["lanes_adjoint_warp"] == 1,
                "K4's launches: the ring kernel under its name, the warp "
                "kernel apart")
        return ring, warp

    def equal(label, dtype, ring, warp, **extra):
        bitwise.append({"case": label, "dtype": str(dtype).replace(
            "torch.", ""), "bitwise": _same_nan(ring, warp), **extra})

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(SEED + 180)
        for label, d, t, seg, kw in K4_CASES:
            adj, _ = _k4_case(rng, d, t, seg, dtype, dev, **kw)
            equal(label, dtype, *both(adj),
                  geometry=list(kl.ring_geometry(
                      adj[0].shape[1], t, seg, adj[2].shape[0],
                      adj[2].shape[1], dtype, dev)))
        edge = sms * kl.adjoint_occupancy(N_SERIES, N_SERIES + N_FACTORS,
                                          dtype, kl.RING_MAX, 2)
        adj, _ = _k4_case(rng, edge + 5, 40, 4, dtype, dev)
        equal(f"B={edge + 5} T=40 seg=4 (past {edge} resident blocks)",
              dtype, *both(adj))
        adj, _ = _k4_case(rng, 6, 197, 16, dtype, dev)
        _, warp = both(adj)
        chooser = kl.ring_geometry
        try:
            for ring, sweep, stages in K4_SHAPES:
                for depth in (ring + 1, ring):
                    shape = kl.RingShape(ring, depth, sweep, stages)
                    kl.ring_geometry = lambda *a, sh=shape: sh
                    equal(f"B=6 T=197 seg=16, {shape}", dtype,
                          kl.lanes_adjoint(*adj), warp)
        finally:
            kl.ring_geometry = chooser
        # the widest one-factor buckets that stage two records, then one,
        # and the warp kernel's widest (it takes no wider)
        two = max(m for m in range(1, 200)
                  if kl.adjoint_smem_bytes(m, m + 1, dtype, 1, 2)
                  + kl.ADJOINT_STATIC_SMEM <= kl.MAX_SMEM)
        warp_n = max(m for m in range(1, 200)
                     if kl.smem_bytes("adjoint_warp", m, m + 1, dtype)
                     <= kl.MAX_SMEM)
        for big_n in (two, two + 1, warp_n):
            adj, _ = _k4_case(rng, 2, 20, 8, dtype, dev,
                              n_pad=big_n - N_SERIES)
            equal(f"({big_n}, {big_n + 1}) B=2 T=20 seg=8", dtype,
                  *both(adj), stages=kl.ring_geometry(
                      2, 20, 8, big_n, big_n + 1, dtype, dev).stages)
    emit({"phase": "k4_bitwise", "checks": bitwise})
    bad = [c for c in bitwise if not c["bitwise"]]
    require(not bad, f"K4's ring kernel differs from its warp kernel: {bad}")

    # the warp kernel against its plain version (the trials case, f32, at
    # the deviance's cotangents, as phase_lanes_kernels holds K4)
    rng = np.random.default_rng(SEED + 181)
    label, d, t, seg, kw = K4_CASES[2]
    adj, _ = _k4_case(rng, d, t, seg, torch.float32, dev, deviance=True,
                      **kw)
    got = kl.lanes_adjoint_warp_kernel(*adj)
    plain_ms, want = cuda_ms(lambda: lanes_adjoint_plain(*adj), reps=1,
                             warm=0)
    torch.cuda.synchronize()
    checks.append(check_entry("lanes_adjoint_warp", label, torch.float32,
                              got, want, 1e-3))
    require(checks[-1]["ok"], f"K4's warp kernel vs plain: {checks[-1]}")

    # the known gap, emitted for both kernels: random cotangents on the
    # near-unit-root lane with every state there, f64
    rng = np.random.default_rng(SEED + 182)
    label, d, t, seg, kw = K4_CASES[1]
    adj, _ = _k4_case(rng, d, t, seg, torch.float64, dev,
                      **{**kw, "unit_root": "all"})
    ring, warp = both(adj)
    want = lanes_adjoint_plain(*adj)
    torch.cuda.synchronize()
    for name, got in (("lanes_adjoint", ring), ("lanes_adjoint_warp", warp)):
        checks.append(check_entry(
            name, f"{label}, every state, random cotangents (known gap)",
            torch.float64, got, want, K4_UNIT_ROOT_GAP))
    require(checks[-1]["ok"] and checks[-2]["ok"]
            and checks[-1]["rel_err"] == checks[-2]["rel_err"],
            f"K4's known near-unit-root gap: {checks[-2:]}")

    timing = k4_times(kl, dev)
    bad = [k for k, v in timing.items() if not v["bitwise"]]
    require(not bad, f"K4's timed ring launches differ from the warp "
            f"kernel's: {bad}")
    geometry = {str(dt).replace("torch.", ""): {
        f"{wn}x{ws}": {
            "ring_block_bytes": kl.adjoint_smem_bytes(wn, ws, dt,
                                                      kl.RING_MAX, 2),
            "record_values": kl.record_stride(wn, ws),
            "ring_bytes_512_lanes": kl.ring_bytes(
                FLEET, K4_SEG, wn, ws, dt, kl.RING_MAX),
            "ring_blocks_per_sm": kl.adjoint_occupancy(wn, ws, dt,
                                                       kl.RING_MAX, 2),
            "warp_kernel_bytes": kl.smem_bytes("adjoint_warp", wn, ws, dt),
            "sms": sms}
        for wn, ws in ((N_SERIES, N_SERIES + N_FACTORS), BUCKET)}
        for dt in (torch.float32, torch.float64)}
    emit({"phase": "k4_times", "shape": f"(20,21) f32 T={T_STEPS} "
          f"seg={K4_SEG}", "times": timing, "geometry": geometry})
    main = timing[f"B={FLEET}"]
    times = {
        "lanes_adjoint_warp": {
            "shape": f"B={FLEET} T={T_STEPS} N={N_SERIES} seg={K4_SEG} f32",
            "ms": min(main["warp_ms"]), "plain_ms": plain_ms,
            "plain_shape": f"{label}, T={t}, seg={seg}, once",
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bounds_by_batch": {key: {"ms": min(v["warp_ms"]),
                                      "bound_ms": v["bound_ms"]}
                                for key, v in timing.items()}},
        "k4_ring_vs_warp": timing}
    return checks, times


# K3's chain kernel against its warp kernel: (label, data lanes, steps,
# seg, keywords of _k3_case): the lanes cases (padded series, a masked
# series and step, a near-unit-root lane, K = 4 trials over a lane map), a
# NaN reading (the guard hands the lane to the oracle's step), seg past
# T, two and three factors (three and four terms in the short sums), a
# dense Z (every column on the chain), B = 1, 8, 64, 512
K3_CASES = (
    ("padded series (24 slots, 20 real), a masked series and step", 16,
     250, K4_SEG, dict(n_pad=4)),
    ("near-unit-root lane (alpha=3e4)", 16, 250, K4_SEG,
     dict(unit_root="factor")),
    ("lane map, K=4 trials over 16 data lanes", 16, 250, K4_SEG,
     dict(trials=4)),
    ("a NaN reading", 8, 60, 16, dict(nan=True)),
    ("seg past T", 4, 30, 64, {}),
    ("two factors", 8, 120, 32, dict(factors=2)),
    ("three factors", 8, 120, 32, dict(factors=3)),
    ("a dense Z", 4, 60, 16, dict(dense=True)),
    ("B=1", 1, 333, K4_SEG, {}),
    ("B=8", 8, 205, 50, {}),
    ("B=64", 64, 130, 40, {}),
    ("B=512", FLEET, 120, 50, {}),
)


def _k3_case(rng, d, t, dtype, dev, nan=False, dense=False, **kw):
    """K3's arguments ``(phi, q, z, r, y, mask, lane_map)`` from
    :func:`lanes_case` and its observed-slot counts; ``nan``: a NaN
    reading at lane 0, step 2, slot 3; ``dense``: every entry of Z
    nonzero (loadings on every state)."""
    import torch

    *args, count = lanes_case(rng, d, t, dtype, dev, **kw)
    if nan:
        args[4][0, 2, 3] = float("nan")
        args[5][0, 2, 3] = True
    if dense:
        args[2] = args[2] + torch.as_tensor(
            rng.uniform(0.05, 0.3, tuple(args[2].shape)), dtype=dtype,
            device=dev)
    return args, count


def k3_times(kl, dev, batches=(FLEET, 64, 8, 1), reps=1):
    """K3's chain kernel and its warp kernel timed alternately (warp,
    chain, chain, warp) at the line search's trial pass (K = 4 trial
    lanes over each of FLEET data lanes, no boundaries) and at each of
    ``batches`` lanes with boundaries, T = 5,000, seg = 100, (20, 21) f32,
    each pair held bit for bit, beside ``k3_cost``'s bound and the shape
    ``chain_shape`` chose: ``{"trials K*B=...": {...}, "B=b": {...}}``."""
    import numpy as np
    import torch

    timing = {}
    rng = np.random.default_rng(SEED + 21)
    *trial, count = lanes_case(rng, FLEET, T_STEPS, torch.float32, dev,
                               trials=LS_TRIALS)
    data_shape = tuple(trial[4].shape)
    runs = [(f"trials K*B={LS_TRIALS * FLEET}", trial, False)]
    for b in batches:
        runs.append((f"B={b}", [a[..., :b].contiguous() for a in trial[:4]]
                     + [trial[4][:b].contiguous(), trial[5][:b].contiguous(),
                        trial[6][:b].contiguous()], True))
    for key, part, bounds in runs:
        got, outs = {"warp": [], "chain": []}, {}
        for who in ("warp", "chain", "chain", "warp"):
            fn = (kl.lanes_filter_warp_kernel if who == "warp"
                  else kl.lanes_filter_kernel)
            ms, outs[who] = cuda_ms(
                lambda: fn(*part, seg=K4_SEG, keep_bounds=bounds), reps=reps,
                warm=1)
            got[who].append(ms)
        lanes = part[0].shape[1]
        bms, bby = bound_ms(*k3_cost(
            part[2], part[6], count[:, :part[4].shape[0]],
            (part[4].shape[0],) + data_shape[1:], K4_SEG, bounds, 4),
            "float32")
        timing[key] = {
            "warp_ms": got["warp"], "chain_ms": got["chain"],
            "speedup": min(got["warp"]) / min(got["chain"]),
            "bound_ms": bms, "bound_by": bby,
            "update_warps": kl.chain_shape(
                lanes, N_SERIES, N_SERIES + N_FACTORS, torch.float32,
                dev).update_warps,
            "bitwise": _same_nan([o for o in outs["chain"] if o is not None],
                                 [o for o in outs["warp"] if o is not None])}
    return timing


def phase_k3_kernels():
    """K3's chain kernel bit for bit its warp kernel, and both timed.

    The chain kernel computes every entry by the warp kernel's operations
    in its order, so the two agree by ``torch.equal`` (NaN in the same
    places), f64 and f32, on K3_CASES, past the card's resident four-warp
    blocks, with three update warps and with none, and at the widest
    bucket;
    each case counts the chain kernel's launch under K3's name and the
    warp kernel's apart (``k3_bitwise``).  Then both timed alternately
    (:func:`k3_times`, ``k3_times``); the warp kernel against its plain
    version on the trials case."""
    import importlib

    import numpy as np
    import torch

    from metran_tpu_torch.kernels import launches, lanes_filter_plain
    from metran_tpu_torch.kernels.build import oracle_launches

    kl = importlib.import_module("metran_tpu_torch.kernels.lanes")
    dev = torch.device(DEVICE)
    bitwise, checks = [], []

    def both(args, seg):
        before = (launches(), oracle_launches())
        chain = kl.lanes_filter(*args, seg=seg, keep_bounds=True)
        mid = (launches(), oracle_launches())
        warp = kl.lanes_filter_warp_kernel(*args, seg=seg, keep_bounds=True)
        after = (launches(), oracle_launches())
        torch.cuda.synchronize()
        require(mid[0]["lanes_filter"] - before[0]["lanes_filter"] == 1
                and mid[1] == before[1] and after[0] == mid[0]
                and after[1]["lanes_filter_warp"]
                - mid[1]["lanes_filter_warp"] == 1,
                "K3's launches: the chain kernel under its name, the warp "
                "kernel apart")
        return chain, warp

    def equal(label, dtype, chain, warp, **extra):
        bitwise.append({"case": label, "dtype": str(dtype).replace(
            "torch.", ""), "bitwise": _same_nan(chain, warp), **extra})

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_state = N_SERIES + N_FACTORS
    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(SEED + 190)
        for label, d, t, seg, kw in K3_CASES:
            args, _ = _k3_case(rng, d, t, dtype, dev, **kw)
            equal(label, dtype, *both(args, seg),
                  update_warps=kl.chain_shape(
                      args[0].shape[1], args[2].shape[0], args[2].shape[1],
                      dtype, dev).update_warps)
        edge = sms * kl.chain_occupancy(N_SERIES, n_state, dtype, 3)
        args, _ = _k3_case(rng, edge + 5, 40, dtype, dev)
        equal(f"B={edge + 5} T=40 seg=4 (past {edge} resident four-warp "
              "blocks)", dtype, *both(args, 4),
              update_warps=kl.chain_shape(edge + 5, N_SERIES, n_state, dtype,
                                          dev).update_warps)
        args, _ = _k3_case(rng, 6, 197, dtype, dev, factors=2)
        _, warp = both(args, 16)
        chooser = kl.chain_shape
        try:
            for u in kl.UPDATE_WARPS:
                kl.chain_shape = lambda *a, u=u: kl.ChainShape(u)
                equal(f"B=6 T=197 seg=16 two factors, U={u}", dtype,
                      kl.lanes_filter(*args, seg=16, keep_bounds=True), warp)
        finally:
            kl.chain_shape = chooser
        # the warp kernel's widest one-factor bucket (the chain kernel
        # takes at least as wide)
        warp_n = max(m for m in range(1, 200)
                     if kl.smem_bytes("filter_warp", m, m + 1, dtype)
                     <= kl.MAX_SMEM)
        args, _ = _k3_case(rng, 2, 20, dtype, dev, n_pad=warp_n - N_SERIES)
        equal(f"({warp_n}, {warp_n + 1}) B=2 T=20 seg=8", dtype,
              *both(args, 8))
    emit({"phase": "k3_bitwise", "checks": bitwise})
    bad = [c for c in bitwise if not c["bitwise"]]
    require(not bad, f"K3's chain kernel differs from its warp kernel: {bad}")

    # the warp kernel against its plain version (the trials case, f32)
    rng = np.random.default_rng(SEED + 191)
    label, d, t, seg, kw = K3_CASES[2]
    args, _ = _k3_case(rng, d, t, torch.float32, dev, **kw)
    got = kl.lanes_filter_warp_kernel(*args, seg=seg, keep_bounds=True)
    plain_ms, want = cuda_ms(
        lambda: lanes_filter_plain(*args, seg=seg, keep_bounds=True), reps=1,
        warm=0)
    torch.cuda.synchronize()
    checks.append(check_entry("lanes_filter_warp", label, torch.float32, got,
                              want, 1e-3))
    require(checks[-1]["ok"], f"K3's warp kernel vs plain: {checks[-1]}")

    timing = k3_times(kl, dev)
    bad = [k for k, v in timing.items() if not v["bitwise"]]
    require(not bad, f"K3's timed chain launches differ from the warp "
            f"kernel's: {bad}")
    geometry = {str(dt).replace("torch.", ""): {
        f"{wn}x{ws}": {
            "chain_block_bytes": kl.smem_bytes("filter", wn, ws, dt),
            "warp_kernel_bytes": kl.smem_bytes("filter_warp", wn, ws, dt),
            "resident_lanes": {f"U={u}": sms * kl.chain_occupancy(
                wn, ws, dt, u) for u in kl.UPDATE_WARPS}}
        for wn, ws in ((N_SERIES, n_state), BUCKET)}
        for dt in (torch.float32, torch.float64)}
    emit({"phase": "k3_times", "shape": f"(20,21) f32 T={T_STEPS} "
          f"seg={K4_SEG}", "times": timing, "geometry": geometry})
    main = timing[f"B={FLEET}"]
    times = {
        "lanes_filter_warp": {
            "shape": f"B={FLEET} T={T_STEPS} N={N_SERIES} seg={K4_SEG} f32 "
                     "with boundaries",
            "ms": min(main["warp_ms"]), "plain_ms": plain_ms,
            "plain_shape": f"{label}, T={t}, seg={seg}, once",
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bounds_by_batch": {key: {"ms": min(v["warp_ms"]),
                                      "bound_ms": v["bound_ms"]}
                                for key, v in timing.items()}},
        "k3_chain_vs_warp": timing}
    return checks, times


def sample_inputs(phi, q, z, r, draws, t, gen):
    """K7's inputs for ``draws`` lanes per model: the lane constants
    tiled (lane ``d * B + model``) and standard normals from ``gen``."""
    import torch

    def rep(a):
        return a.repeat(*([1] * (a.dim() - 1)), draws)

    phi_l, q_l, z_l, r_l = rep(phi), rep(q), rep(z), rep(r)
    n, lanes = phi_l.shape
    new = dict(generator=gen, dtype=phi.dtype, device=phi.device)
    return (phi_l, q_l, z_l, r_l, torch.randn((lanes, n), **new),
            torch.randn((lanes, t, n), **new),
            torch.randn((lanes, t, z.shape[0]), **new))


def phase_products_kernels():
    """K5 (the smoother's backward pass), K6 (the forward filter with
    per-step outputs) and K7 (the path draw) against their plain versions
    on the card: small cases in f64 and f32, then the products path's
    launches at full width in f32 (held against the plain versions over
    the first T_CMP steps, timed at the full T)."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import (
        lanes_filter,
        lanes_forward,
        lanes_forward_plain,
        lanes_sample,
        lanes_sample_plain,
        lanes_smooth_bwd,
        lanes_smooth_bwd_plain,
    )
    from metran_tpu_torch.ops.lanes_products import _innovations_lanes

    dev = torch.device(DEVICE)
    checks = []

    def compare(*args):
        checks.append(check_entry(*args))

    seg, t_small = PRODUCTS["seg"], 250
    for dtype, bar in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        cases = [
            ("padded series (24 slots, 20 real), a masked series, the "
             "first step, step 3 and a 20-step stretch masked, T=250 "
             "seg=100", dict(n_pad=4)),
            # f32: the cap-pinned factor, as in the K3/K4 checks
            ("near-unit-root lane (alpha=3e4), the same gaps",
             dict(unit_root="all" if dtype == torch.float64 else "factor")),
        ]
        for label, kw in cases:
            rng = np.random.default_rng(SEED + 40)
            *args, _ = lanes_case(rng, 16, t_small, dtype, dev, gaps=True,
                                  **kw)
            lanes = args[0].shape[1]
            fwd = lanes_filter(*args, seg=seg, keep_bounds=True)
            for want_cov in (True, False):
                sm = (*args, seg, fwd.bounds_mean, fwd.bounds_cov, want_cov)
                got = lanes_smooth_bwd(*sm)
                want = lanes_smooth_bwd_plain(*sm)
                torch.cuda.synchronize()
                compare("lanes_smooth_bwd", f"{label}, "
                        f"{'with' if want_cov else 'without'} covariance",
                        dtype, got, want, bar)
            for mode in ("project", "innovations"):
                got = lanes_forward(*args[:6], mode, args[6])
                want = lanes_forward_plain(*args[:6], mode, args[6])
                torch.cuda.synchronize()
                compare("lanes_forward", f"{label}, {mode}", dtype, got,
                        want, bar)
            t_last = torch.as_tensor(
                np.r_[0, t_small, rng.integers(1, t_small, lanes - 2)],
                dtype=torch.int32, device=dev)
            got = lanes_forward(*args[:6], "latch", args[6], t_last)
            want = lanes_forward_plain(*args[:6], "latch", args[6], t_last)
            torch.cuda.synchronize()
            compare("lanes_forward", f"{label}, latch at t_last in [0, T] "
                    "(0 and T among them)", dtype, got, want, bar)
            # standardized and masked with warmup > 0: the kernel path on
            # the card against the plain path on CPU copies
            got = _innovations_lanes(*args[:6], True, 50)
            want = _innovations_lanes(*(a.cpu() for a in args[:6]), True, 50)
            compare("lanes_forward", f"{label}, standardized innovations, "
                    "warmup=50 (plain on the CPU)", dtype, got,
                    [w.to(dev) for w in want], bar)
        rng = np.random.default_rng(SEED + 41)
        *args, _ = lanes_case(rng, 16, t_small, dtype, dev)
        phi, q, z, r = args[:4]
        r = r.clone()
        r[:, ::2] = 0.1  # the measurement-noise term in every other lane
        k7 = sample_inputs(phi, q, z, r, 4, t_small,
                           torch.Generator(dev).manual_seed(SEED + 42))
        got = lanes_sample(*k7)
        want = lanes_sample_plain(*k7)
        torch.cuda.synchronize()
        compare("lanes_sample", "4 draws x 16 models, T=250, r > 0 in every "
                "other model", dtype, got, want, bar)

    # the products path's launches at full width, f32
    dtype = torch.float32
    times = {}
    rng = np.random.default_rng(SEED + 43)
    *args, count = lanes_case(rng, FLEET, T_STEPS, dtype, dev)
    lane_map, z = args[6], args[2]
    data_shape = tuple(args[4].shape)
    cmp_args = short_args(args)

    def main_shape(kernel, key, label, fn, plain, cmp, full, cost,
                   plain_t=T_CMP):
        got = fn(*cmp)
        plain_ms, want = cuda_ms(lambda: plain(*cmp), reps=1, warm=0)
        compare(kernel, f"main path: {label}, T={plain_t} f32", dtype, got,
                want, 1e-3)
        ms, _ = cuda_ms(lambda: fn(*full), reps=3, warm=1)
        bms, bby = bound_ms(*cost, "float32")
        times[key] = {"shape": f"{label}, T={T_STEPS} f32", "ms": ms,
                      "plain_ms": plain_ms,
                      "plain_shape": f"{label}, T={plain_t}, once",
                      "bound_ms": bms, "bound_by": bby}

    fwd_cmp = lanes_filter(*cmp_args, seg=seg, keep_bounds=True)
    fwd_full = lanes_filter(*args, seg=seg, keep_bounds=True)
    for want_cov, key in ((True, "lanes_smooth_bwd"),
                          (False, "lanes_smooth_bwd_mean")):
        main_shape(
            "lanes_smooth_bwd", key,
            f"B={FLEET} lanes seg={seg} "
            f"{'with' if want_cov else 'without'} covariance",
            lanes_smooth_bwd, lanes_smooth_bwd_plain,
            (*cmp_args, seg, fwd_cmp.bounds_mean, fwd_cmp.bounds_cov,
             want_cov),
            (*args, seg, fwd_full.bounds_mean, fwd_full.bounds_cov, want_cov),
            k5_cost(z, lane_map, count, data_shape, seg, want_cov, 4))
    for mode in ("project", "innovations", "latch"):
        tl_cmp = tl_full = None
        if mode == "latch":  # every model's data ends at T
            tl_cmp, tl_full = (torch.full((FLEET,), t, dtype=torch.int32,
                                          device=dev)
                               for t in (T_CMP, T_STEPS))
        main_shape(
            "lanes_forward",
            "lanes_forward" if mode == "project" else f"lanes_forward_{mode}",
            f"B={FLEET} lanes, {mode}", lanes_forward, lanes_forward_plain,
            (*cmp_args[:6], mode, lane_map, tl_cmp),
            (*args[:6], mode, lane_map, tl_full),
            k6_cost(z, lane_map, count, data_shape, mode, tl_full, 4))
    # the path draw over D*B lanes, and the mean-only smoothing of its
    # pseudo-observations (the simulation smoother's second pass)
    draws = PRODUCTS["n_draws"]
    k7 = sample_inputs(*args[:4], draws, T_STEPS,
                       torch.Generator(dev).manual_seed(SEED + 44))
    main_shape("lanes_sample", "lanes_sample",
               f"{draws}x{FLEET}={draws * FLEET} lanes", lanes_sample,
               lanes_sample_plain, k7, k7,
               k7_cost(k7[2], k7[3], T_STEPS, 4), plain_t=T_STEPS)
    xs, y_star = lanes_sample(*k7)
    del xs
    star = (*k7[:4], y_star, args[5].repeat(draws, 1, 1))
    star_count = star[5].sum(2).T
    star_map = torch.arange(draws * FLEET, dtype=torch.int32, device=dev)
    star_cmp = short_args([*star, star_map])
    fwd_cmp = lanes_filter(*star_cmp, seg=seg, keep_bounds=True)
    fwd_full = lanes_filter(*star, seg=seg, keep_bounds=True)
    main_shape(
        "lanes_smooth_bwd", "lanes_smooth_bwd_sample",
        f"{draws}x{FLEET}={draws * FLEET} lanes seg={seg} without "
        "covariance (pseudo-observations)", lanes_smooth_bwd,
        lanes_smooth_bwd_plain,
        (*star_cmp, seg, fwd_cmp.bounds_mean, fwd_cmp.bounds_cov, False),
        (*star, None, seg, fwd_full.bounds_mean, fwd_full.bounds_cov, False),
        k5_cost(star[2], star_map, star_count, tuple(star[4].shape), seg,
                False, 4))
    emit({"phase": "products_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar", "ok")}
        for c in checks], "times": times})
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"kernel disagrees with its plain version: {bad}")
    return checks, times


def phase_single_kernels():
    """K6 in its ``store`` mode and K8 (the RTS smoother) against their
    plain versions on the card, f64 and f32, over T_CMP steps at the
    flagship widths (n=21): one lane, 16 lanes (a draw chunk, K8 with and
    without the covariance) and one lane whose predicted covariance is
    made indefinite at one step (K8 must degrade that step to its
    filtered moments); then both timed at the full T in f32, one lane
    (the single model's filter and smoother) and 16 lanes (a chunk of
    path draws, K8 mean-only)."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import lanes_forward, lanes_forward_plain
    from metran_tpu_torch.kernels.smoother import (
        rts_smooth,
        rts_smooth_plain,
    )

    dev = torch.device(DEVICE)
    checks = []

    def compare(*args):
        checks.append(check_entry(*args))

    bad = T_CMP // 2  # the step whose P_p is made indefinite
    for dtype, bar in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        for label, lanes, degrade in (
                ("one lane", 1, False), ("16 lanes (a draw chunk)", 16, False),
                (f"one lane, P_p indefinite at step {bad}", 1, True)):
            rng = np.random.default_rng(SEED + 50)
            *args, _ = lanes_case(rng, lanes, T_CMP, dtype, dev)
            got = lanes_forward(*args[:6], "store", args[6])
            want = lanes_forward_plain(*args[:6], "store", args[6])
            torch.cuda.synchronize()
            compare("lanes_forward", f"{label}, store, n=21 T={T_CMP}",
                    dtype, got, want, bar)
            mean_p, cov_p, mean_f, cov_f = want[:4]
            if degrade:
                cov_p = cov_p.clone()
                cov_p[:, bad] -= 10.0 * torch.eye(cov_p.shape[-1],
                                                  dtype=dtype, device=dev)
            sm = (args[0].T.contiguous(), mean_f, cov_f, mean_p, cov_p)
            for want_cov in (True, False) if lanes > 1 else (True,):
                got = rts_smooth(*sm, want_cov=want_cov)
                ref = rts_smooth_plain(*sm, want_cov=want_cov)
                torch.cuda.synchronize()
                compare("rts_smooth", f"{label}, n=21 T={T_CMP}, "
                        f"{'with' if want_cov else 'without'} covariance",
                        dtype, got, ref, bar)
            if degrade:
                require(torch.equal(got[0][:, bad - 1], mean_f[:, bad - 1])
                        and torch.equal(got[1][:, bad - 1],
                                        cov_f[:, bad - 1]),
                        "K8 did not degrade the step to its filtered "
                        "moments")

    dtype = torch.float32
    times = {}
    rng = np.random.default_rng(SEED + 51)
    for lanes, key, want_cov in ((1, "", True), (16, "_draw_chunk", False)):
        *args, count = lanes_case(rng, lanes, T_STEPS, dtype, dev)
        cmp = short_args(args)
        phi_l = args[0].T.contiguous()
        plain6, st_cmp = cuda_ms(
            lambda: lanes_forward_plain(*cmp[:6], "store", cmp[6]), reps=1,
            warm=0)
        ms6, st = cuda_ms(lambda: lanes_forward(*args[:6], "store", args[6]),
                          reps=5, warm=1)
        bms6, bby6 = bound_ms(*k6_cost(args[2], args[6], count,
                                       tuple(args[4].shape), "store", None,
                                       4), "float32")
        label = f"{lanes} lane{'s' if lanes > 1 else ''}, n=21 T={T_STEPS} f32"
        times[f"lanes_forward_store{key}"] = {
            "shape": f"{label}, store", "ms": ms6, "plain_ms": plain6,
            "plain_shape": f"{lanes} lanes, T={T_CMP}, once",
            "bound_ms": bms6, "bound_by": bby6}
        plain8, _ = cuda_ms(
            lambda: rts_smooth_plain(phi_l, st_cmp[2], st_cmp[3], st_cmp[0],
                                     st_cmp[1], want_cov=want_cov),
            reps=1, warm=0)
        ms8, _ = cuda_ms(
            lambda: rts_smooth(phi_l, st[2], st[3], st[0], st[1],
                               want_cov=want_cov), reps=5, warm=1)
        bms8, bby8 = bound_ms(*k8_cost(st[1], want_cov, 4), "float32")
        times[f"rts_smooth{key}"] = {
            "shape": f"{label}, {'with' if want_cov else 'without'} "
                     "covariance", "ms": ms8, "plain_ms": plain8,
            "plain_shape": f"{lanes} lanes, T={T_CMP}, once",
            "bound_ms": bms8, "bound_by": bby8}
    emit({"phase": "single_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar", "ok")}
        for c in checks], "times": times})
    bad_checks = [c for c in checks if not c["ok"]]
    require(not bad_checks,
            f"kernel disagrees with its plain version: {bad_checks}")
    return checks, times


def _sqrt_cmp(out, store):
    """K9's outputs as compared: a filtered factor through the covariance
    it stands for (rank-deficient under r = 0, so its columns past a
    zero pivot are any orthonormal completion), the rest entrywise."""
    from metran_tpu_torch.ops import chol_outer

    if store:
        mean_p, chol_p, mean_f, chol_f, sigma, detf = out
        return (mean_p, chol_p, mean_f, chol_outer(chol_f), sigma, detf)
    mean, chol, sigma, detf = out
    return (mean, chol_outer(chol), sigma, detf)


def sqrt_bucket_case(rng, batch, dtype, dev):
    """The serving bucket's K9 inputs at k = 1: the flagship fleet padded
    into (24, 32) in the lanes layout, a given carry per slot (a random
    mean and a factor that is not triangular, as a migrated state's is)
    and slot 7 observing slot 0 with r < 0."""
    import numpy as np
    import torch

    from metran_tpu_torch.ops.kalman import _lanes_ss
    from metran_tpu_torch.ops.statespace import StateSpace

    phi, q, z, r, y, mask = padded_inputs(rng, batch, 1, dtype, dev)
    lanes = _lanes_ss(StateSpace(phi, q, z, r), "sqrt")
    s = phi.shape[1]
    a = rng.normal(size=(batch, s, s)) / np.sqrt(s)
    cov = a @ np.swapaxes(a, 1, 2) + 0.05 * np.eye(s)
    w, v = np.linalg.eigh(cov)
    chol0 = torch.as_tensor(v * np.sqrt(w)[:, None, :], dtype=dtype,
                            device=dev)
    mean0 = torch.as_tensor(rng.normal(size=(batch, s)), dtype=dtype,
                            device=dev)
    r_l = lanes[3].clone()
    r_l[0, 7] = -1.0
    mask = mask.clone()
    mask[7, 0, 0] = True
    return (*lanes[:3], r_l, y.contiguous(), mask.contiguous(), None,
            mean0, chol0)


K9_SEG = 4  # the segment of K9's group-vs-block cases (short, many segments)
# K9's group-vs-block cases: (label, lanes, steps, widths (N, factors)).
# Lane 0 reads a NaN at step 2, the last lane observes a slot with r < 0,
# step 1 is all masked and step 2 fully observed (o = N); the given carry
# is not triangular
K9_CASES = (
    ("B=1 T=9", 1, 9, (N_SERIES, N_FACTORS)),
    ("B=8 T=2seg+3", 8, 2 * K9_SEG + 3, (N_SERIES, N_FACTORS)),
    ("B=64 T=seg+1", 64, K9_SEG + 1, (N_SERIES, N_FACTORS)),
    (f"B={FLEET} T=3", FLEET, 3, (N_SERIES, N_FACTORS)),
)
# the widest buckets of eights the block kernel takes, and buckets whose
# group layout drops its odd leading dimensions and Z's bits
K9_WIDE = (
    ("float32", "B=2 N=72 n=80 (f32's widest bucket of eights)", (72, 8)),
    ("float32", "B=2 N=73 n=82 (no odd strides, no bits)", (73, 9)),
    ("float64", "B=2 N=48 n=56 (f64's widest bucket of eights)", (48, 8)),
    ("float64", "B=2 N=40 n=62 (no odd strides, no bits)", (40, 22)),
)
K9_SHAPE_LANES = 13  # lanes of the case run at every launch shape


def _k9_case(rng, b, t, widths, dtype, dev):
    """K9's lanes-layout arguments ``(phi, q, z, r, y, mask, lane_map)``
    and a given carry ``(mean0, chol0)`` that is not triangular, with the
    NaN reading, the r < 0 slot and the masked and full steps of
    K9_CASES."""
    import numpy as np
    import torch

    from metran_tpu_torch.ops import dfm_statespace

    big_n, kf = widths
    ss = dfm_statespace(rng.uniform(5, 40, (b, big_n)),
                        rng.uniform(10, 60, (b, kf)),
                        rng.uniform(0.3, 0.8, (b, big_n, kf)) / kf, 1.0,
                        device=dev, dtype=dtype)
    n = big_n + kf
    r = torch.full((big_n, b), 0.2, dtype=dtype, device=dev)
    r[1, b - 1] = -1.0
    mask = rng.uniform(size=(b, t, big_n)) > 0.3
    if t > 1:
        mask[:, 1] = False
    if t > 2:
        mask[:, 2] = True
    y = np.where(mask, rng.normal(size=mask.shape), 0.0)
    if t > 2:
        y[0, 2, 3] = np.nan
    a = rng.normal(size=(b, n, n)) / np.sqrt(n)
    new = dict(dtype=dtype, device=dev)
    return ((ss.phi.T.contiguous(),
             torch.diagonal(ss.q, 0, -2, -1).T.contiguous(),
             ss.z.permute(1, 2, 0).contiguous(), r,
             torch.as_tensor(y, **new), torch.as_tensor(mask, device=dev),
             torch.arange(b, dtype=torch.int32, device=dev)),
            torch.as_tensor(rng.normal(size=(b, n)), **new),
            torch.as_tensor(a, **new))


def _k9_modes(sf, args, m0, c0, group):
    """K9's every instantiation through the group (or the block) kernel:
    store, carry from (0, I) over all steps and the first, bounds every
    K9_SEG steps, carry from the given carry, the gate's three policies
    and the three robust likelihoods from it."""
    import torch

    kind = "kernel" if group else "block"
    run = getattr(sf, f"sqrt_filter_{kind}")
    gated = getattr(sf, f"sqrt_filter_gated_{kind}")
    robust = getattr(sf, f"sqrt_filter_robust_{kind}")
    b, big_n = args[0].shape[1], args[2].shape[0]
    armed = torch.arange(b, device=m0.device) % 3 != 1
    first = (*args[:4], args[4][:, :1].contiguous(),
             args[5][:, :1].contiguous(), args[6])
    out = {"store": run(*args, store=True), "carry": run(*args),
           "carry k=1": run(*first),
           "bounds": run(*args, bounds_seg=K9_SEG),
           "given carry": run(*args, mean0=m0, chol0=c0)}
    for policy in ("reject", "huber", "inflate"):
        out[policy] = gated(*args[:6], m0, c0, armed, policy, 1.0, args[6])
    par = [torch.full((b, big_n), v, dtype=m0.dtype, device=m0.device)
           for v in (-0.5, 0.5, 0.1, 0.5)]
    for lik in ROBUST_LIKELIHOODS:
        out[lik] = robust(*args[:6], m0, c0, armed, *par, lik, 4.0, args[6])
    return out


def _same_nan(a, b) -> bool:
    """``torch.equal`` of every output, NaN in the same places."""
    import torch

    def eq(x, y):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if not x.is_floating_point():
            return bool(torch.equal(x, y))
        nx, ny = torch.isnan(x), torch.isnan(y)
        return bool(torch.equal(nx, ny)) and bool(torch.equal(x[~nx],
                                                              y[~ny]))
    return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))


def k9_group_vs_block(dev):
    """K9's group kernel bit for bit its block kernel, and both timed.

    The group kernel computes every output by the block kernel's sequence
    of operations, so the two must agree by ``torch.equal`` (NaN in the
    same places) in every instantiation (:func:`_k9_modes`), f64 and
    f32, on K9_CASES, past the resident four-warp blocks, at every launch
    shape (K9_SHAPE_LANES lanes), on K9_WIDE, from a huge finite carry
    (a predict reflector's multiplier overflows), at the serving bucket
    (512 slots, (24, 32), k = 1, given non-triangular carries) and at the
    timed flagship launches (T = 5,000).  Each case counts the group
    kernel's launches under K9's names and the block kernel's apart.
    Then both timed alternately (block, group, group, block): ``bounds``
    at B = 512, 64, 8, 1, ``store`` at B = 1 and 16, the serving update
    and its ``reject`` gate at B = 512, each beside its bound; the block
    kernel against its plain version at the serving update."""
    import importlib

    import numpy as np
    import torch

    from metran_tpu_torch.kernels import launches
    from metran_tpu_torch.kernels.build import oracle_launches

    sf = importlib.import_module("metran_tpu_torch.kernels.sqrt_filter")
    bitwise, checks = [], []
    names = ("sqrt_filter", "sqrt_filter_gated", "sqrt_filter_robust")

    def equal(label, dtype, a, b):
        bitwise.append({"case": label, "dtype": str(dtype).replace(
            "torch.", ""), "bitwise": {m: _same_nan(a[m], b[m]) for m in a}})

    def counted(args, m0, c0, group):
        before = (launches(), oracle_launches())
        out = _k9_modes(sf, args, m0, c0, group)
        after = (launches(), oracle_launches())
        own, other = (0, 1) if group else (1, 0)
        keys = names if group else tuple(k + "_block" for k in names)
        require([after[own][k] - before[own][k] for k in keys] == [5, 3, 3]
                 and after[other] == before[other],
                 f"K9 {'group' if group else 'block'} kernel: its launches")
        return out

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(SEED + 170)
        for label, b, t, widths in K9_CASES:
            args, m0, c0 = _k9_case(rng, b, t, widths, dtype, dev)
            equal(label, dtype, counted(args, m0, c0, True),
                  counted(args, m0, c0, False))
        edge = sms * sf.occupancy(N_SERIES, N_SERIES + N_FACTORS, dtype,
                                  "carry", 1, sf.MAX_GROUP)
        args, m0, c0 = _k9_case(rng, edge + 5, 3, (N_SERIES, N_FACTORS),
                                dtype, dev)
        equal(f"B={edge + 5} T=3 (past {edge} resident four-warp blocks)",
              dtype, _k9_modes(sf, args, m0, c0, True),
              _k9_modes(sf, args, m0, c0, False))
        args, m0, c0 = _k9_case(rng, K9_SHAPE_LANES, 2 * K9_SEG + 1,
                                (N_SERIES, N_FACTORS), dtype, dev)
        block = _k9_modes(sf, args, m0, c0, False)
        fit = sf.MAX_SMEM // sf.model_bytes(N_SERIES, N_SERIES + N_FACTORS,
                                            dtype)
        shapes = [(w, g) for g in (sf.MIN_GROUP, sf.MAX_GROUP)
                  for w in range(1, min(sf.MAX_WARPS // g, fit) + 1)]
        chooser = sf.launch_shape
        try:
            for shape in shapes:
                sf.launch_shape = lambda *a, shape=shape: shape
                equal(f"B={K9_SHAPE_LANES}, (W, G)={shape}", dtype,
                      _k9_modes(sf, args, m0, c0, True), block)
        finally:
            sf.launch_shape = chooser
        for name, label, widths in K9_WIDE:
            if name != str(dtype).replace("torch.", ""):
                continue
            args, m0, c0 = _k9_case(rng, 2, K9_SEG + 3, widths, dtype, dev)
            equal(label, dtype, _k9_modes(sf, args, m0, c0, True),
                  _k9_modes(sf, args, m0, c0, False))
        args, m0, c0 = _k9_case(rng, 3, 4, (N_SERIES, N_FACTORS), dtype, dev)
        big = 1e25 if dtype == torch.float32 else 1e200
        c0, m0 = torch.tril(c0) * big, m0 * big
        equal("B=3 T=4, a huge finite carry", dtype,
              _k9_modes(sf, args, m0, c0, True),
              _k9_modes(sf, args, m0, c0, False))
        case = sqrt_bucket_case(np.random.default_rng(SEED + 81), FLEET,
                                dtype, dev)
        serve = {True: {}, False: {}}
        for group in (True, False):
            kind = "kernel" if group else "block"
            serve[group]["carry"] = getattr(sf, f"sqrt_filter_{kind}")(
                *case[:7], mean0=case[7], chol0=case[8])
            armed = torch.ones(FLEET, dtype=torch.bool, device=dev)
            serve[group]["reject"] = getattr(
                sf, f"sqrt_filter_gated_{kind}")(
                *case[:6], case[7], case[8], armed, "reject",
                GATE_NSIGMA ** 2, case[6])
        equal(f"serving bucket {BUCKET}, {FLEET} slots, k=1, given "
              "non-triangular carries", dtype, serve[True], serve[False])
        del serve
    emit({"phase": "k9_bitwise", "checks": bitwise})
    bad = [c for c in bitwise if not all(c["bitwise"].values())]
    require(not bad, f"K9's group kernel differs from its block kernel: "
            f"{bad}")

    # both kernels timed, alternating; each timed pair held bit for bit
    def alternate(block_fn, group_fn, cost, reps=1, dtype="float32"):
        got = {"block": [], "group": []}
        outs = {}
        for who in ("block", "group", "group", "block"):
            ms, outs[who] = cuda_ms(block_fn if who == "block" else group_fn,
                                    reps=reps, warm=1)
            got[who].append(ms)
        bms, bby = bound_ms(*cost, dtype)
        return {"block_ms": got["block"], "group_ms": got["group"],
                "speedup": min(got["block"]) / min(got["group"]),
                "bound_ms": bms, "bound_by": bby,
                "bitwise": _same_nan(outs["group"], outs["block"])}

    rng = np.random.default_rng(SEED + 95)
    ss, y, mask = _adjoint_case(rng, FLEET, T_STEPS, torch.float32, dev)
    n = ss.phi.shape[1]
    qd = torch.diagonal(ss.q, 0, -2, -1)
    full = (ss.phi.T, qd.T, ss.z.permute(1, 2, 0), ss.r.T, y, mask)
    timing = {}
    for b in dict.fromkeys(min(b, FLEET) for b in (FLEET, 64, 8, 1)):
        part = [a[..., :b].contiguous() if i < 4 else a[:b].contiguous()
                for i, a in enumerate(full)]
        lane_map = torch.arange(b, dtype=torch.int32, device=dev)
        timing[f"bounds B={b}"] = alternate(
            lambda: sf.sqrt_filter_block(*part, bounds_seg=ADJ_SEG),
            lambda: sf.sqrt_filter_kernel(*part, bounds_seg=ADJ_SEG),
            bounds_cost(k9_cost(part[2], part[5], lane_map, False, False, 4),
                        b, n, T_STEPS, ADJ_SEG, 4))
        timing[f"bounds B={b}"]["launch_shape"] = sf.launch_shape(
            b, N_SERIES, n, torch.float32, dev, "bounds")
    rng = np.random.default_rng(SEED + 82)
    for b in (1, 16):
        *args, _ = lanes_case(rng, b, T_STEPS, torch.float32, dev)
        timing[f"store B={b}"] = alternate(
            lambda: sf.sqrt_filter_block(*args, store=True),
            lambda: sf.sqrt_filter_kernel(*args, store=True),
            k9_cost(args[2], args[5], args[6], True, False, 4))
    case = sqrt_bucket_case(np.random.default_rng(SEED + 81), FLEET,
                            torch.float32, dev)
    lane_map = torch.arange(FLEET, dtype=torch.int32, device=dev)
    label = f"serving update B={FLEET} k=1 {BUCKET}"
    timing[label] = alternate(
        lambda: sf.sqrt_filter_block(*case[:7], mean0=case[7],
                                     chol0=case[8]),
        lambda: sf.sqrt_filter_kernel(*case[:7], mean0=case[7],
                                      chol0=case[8]),
        k9_cost(case[2], case[5], lane_map, False, True, 4), reps=20)
    armed = torch.ones(FLEET, dtype=torch.bool, device=dev)
    timing[f"reject gate B={FLEET} k=1 {BUCKET}"] = alternate(
        lambda: sf.sqrt_filter_gated_block(*case[:6], case[7], case[8],
                                           armed, "reject", GATE_NSIGMA ** 2,
                                           case[6]),
        lambda: sf.sqrt_filter_gated_kernel(*case[:6], case[7], case[8],
                                            armed, "reject",
                                            GATE_NSIGMA ** 2, case[6]),
        k9_gated_cost(case[2], case[5], lane_map, 4), reps=20)
    bad = [k for k, v in timing.items() if not v["bitwise"]]
    require(not bad, f"K9's timed group launches differ from the block "
            f"kernel's: {bad}")
    # the block kernel against plain at the serving update
    block_ms, got = cuda_ms(lambda: sf.sqrt_filter_block(
        *case[:7], mean0=case[7], chol0=case[8]))
    cpu = [None if a is None else a.cpu() for a in case]
    plain_ms, want = cuda_ms(lambda: sf.sqrt_filter_plain(
        *cpu[:7], mean0=cpu[7], chol0=cpu[8]), reps=1, warm=0)
    checks.append(check_entry(
        "sqrt_filter_block", f"serving bucket {BUCKET}, {FLEET} slots, k=1, "
        "given carry (plain on the CPU)", torch.float32,
        [a.cpu() for a in _sqrt_cmp(got, False)], _sqrt_cmp(want, False),
        1e-3))
    geometry = {str(dt).replace("torch.", ""): {
        f"{wn}x{ws}": {"model_bytes": sf.model_bytes(wn, ws, dt),
                       "block_kernel_bytes": sf.block_smem_bytes(wn, ws, dt),
                       "four_warp_blocks_per_sm": sf.occupancy(
                           wn, ws, dt, "bounds", 1, sf.MAX_GROUP),
                       "sms": sms}
        for wn, ws in ((N_SERIES, n), BUCKET)}
        for dt in (torch.float32, torch.float64)}
    emit({"phase": "k9_times", "shape": f"(20,21) f32 T={T_STEPS} "
          f"seg={ADJ_SEG}; serving {BUCKET} k=1", "times": timing,
          "geometry": geometry})
    times = {
        "sqrt_filter_block": {
            "shape": f"{label} f32, given carry", "ms": block_ms,
            "plain_ms": plain_ms,
            "plain_shape": f"{FLEET} slots, k=1, on the CPU, once",
            **{key: timing[label][key] for key in ("bound_ms", "bound_by")},
            "bounds_by_batch": {key: {"ms": min(v["block_ms"]),
                                      "bound_ms": v["bound_ms"]}
                                for key, v in timing.items()
                                if key.startswith("bounds")}},
        "k9_group_vs_block": timing}
    return checks, times


def phase_sqrt_kernels():
    """K9 (the square-root filter) and K10 (the factored smoother) against
    their plain versions on the card, f64 and f32, NaN-strict: at the
    flagship widths (n = 21) over T_CMP steps, one lane and 16 lanes (a
    draw chunk), each with a fully masked series, a fully masked step,
    a masked first step and 20-step gaps, and one lane observing a slot
    with r < 0 (detf = +inf, the state passed through, in both); K9 in
    its store and carry-only instantiations and from a given carry, K10
    with and without the covariance; and the serving bucket (512 slots,
    (24, 32), k = 1) from given, non-triangular carries.  Then both timed
    at the full T in f32 beside their bounds."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels.sqrt_filter import (
        sqrt_filter,
        sqrt_filter_plain,
    )
    from metran_tpu_torch.kernels.sqrt_smoother import (
        sqrt_smooth,
        sqrt_smooth_plain,
    )
    from metran_tpu_torch.ops import chol_outer

    dev = torch.device(DEVICE)
    checks = []

    def compare(kernel, case, dtype, got, want, bar):
        checks.append(check_entry(kernel, case, dtype, got, want, bar))

    for dtype, bar in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        for label, lanes in (("one lane", 1), ("16 lanes (a draw chunk)",
                                                16)):
            rng = np.random.default_rng(SEED + 80)
            *args, _ = lanes_case(rng, lanes, T_CMP, dtype, dev, gaps=True)
            bad = lanes - 1  # in a chunk, the lane observing r < 0
            if lanes > 1:
                args[3] = args[3].clone()
                args[3][0, bad] = -1.0
            case = f"{label}, n=21 T={T_CMP}"
            want = sqrt_filter_plain(*args, store=True)
            got = sqrt_filter(*args, store=True)
            torch.cuda.synchronize()
            compare("sqrt_filter", f"{case}, store", dtype,
                    _sqrt_cmp(got, True), _sqrt_cmp(want, True), bar)
            if lanes > 1:
                # every step that observes the r < 0 slot fails `ok`:
                # detf = +inf, sigma = 0, the state passed through
                hit = args[5][int(args[6][bad]), :, 0]
                require(bool(hit.any())
                        and torch.equal(torch.isinf(got[5][bad]), hit)
                        and bool((got[4][bad][hit] == 0).all())
                        and torch.equal(got[2][bad][hit], got[0][bad][hit]),
                        "K9: the r < 0 lane was not passed through with "
                        "detf = +inf")
            got = sqrt_filter(*args)
            ref = sqrt_filter_plain(*args)
            torch.cuda.synchronize()
            compare("sqrt_filter", f"{case}, carry from (0, I)", dtype,
                    _sqrt_cmp(got, False), _sqrt_cmp(ref, False), bar)
            half = T_CMP // 2
            m0 = want[2][:, half].contiguous()
            c0 = want[3][:, half].contiguous()
            short = [*args[:4], args[4][:, half + 1:].contiguous(),
                     args[5][:, half + 1:].contiguous(), args[6]]
            got = sqrt_filter(*short, mean0=m0, chol0=c0)
            ref = sqrt_filter_plain(*short, mean0=m0, chol0=c0)
            torch.cuda.synchronize()
            compare("sqrt_filter", f"{case}, carry from step {half}",
                    dtype, _sqrt_cmp(got, False), _sqrt_cmp(ref, False),
                    bar)
            sm = (args[0].T.contiguous(), args[1].T.contiguous(), want[2],
                  want[3], want[0], want[1])
            for want_cov in (True, False):
                got = sqrt_smooth(*sm, want_cov=want_cov)
                ref = sqrt_smooth_plain(*sm, want_cov=want_cov)
                torch.cuda.synchronize()
                pair = ((got[0], chol_outer(got[1])),
                        (ref[0], chol_outer(ref[1]))
                        ) if want_cov else ((got[0],), (ref[0],))
                compare("sqrt_smooth", f"{case}, "
                        f"{'with' if want_cov else 'without'} covariance",
                        dtype, *pair, bar)
        rng = np.random.default_rng(SEED + 81)
        case = sqrt_bucket_case(rng, FLEET, dtype, dev)
        got = sqrt_filter(*case[:7], mean0=case[7], chol0=case[8])
        cpu = [None if a is None else a.cpu() for a in case]
        ref = sqrt_filter_plain(*cpu[:7], mean0=cpu[7], chol0=cpu[8])
        torch.cuda.synchronize()
        compare("sqrt_filter", f"serving bucket {BUCKET}, {FLEET} slots, "
                "k=1, given carry (plain on the CPU)", dtype,
                [a.cpu() for a in _sqrt_cmp(got, False)],
                _sqrt_cmp(ref, False), bar)
        require(bool(torch.isinf(got[3][7, 0])), "K9: slot 7 (r < 0) "
                "did not book detf = +inf")

    dtype = torch.float32
    times = {}
    rng = np.random.default_rng(SEED + 82)
    for lanes, key in ((1, ""), (16, "_draw_chunk")):
        *args, _ = lanes_case(rng, lanes, T_STEPS, dtype, dev)
        cmp = short_args(args)
        label = (f"{lanes} lane{'s' if lanes > 1 else ''}, n=21 "
                 f"T={T_STEPS} f32")
        plain_shape = f"{lanes} lane{'s' if lanes > 1 else ''}, T={T_CMP}, once"
        plain9, st_cmp = cuda_ms(
            lambda: sqrt_filter_plain(*cmp, store=True), reps=1, warm=0)
        ms9, st = cuda_ms(lambda: sqrt_filter(*args, store=True), reps=3,
                          warm=1)
        bms, bby = bound_ms(*k9_cost(args[2], args[5], args[6], True, False,
                                     4), "float32")
        times[f"sqrt_filter{key}"] = {
            "shape": f"{label}, store", "ms": ms9, "plain_ms": plain9,
            "plain_shape": plain_shape, "bound_ms": bms, "bound_by": bby}
        want_cov = lanes == 1
        sm = (args[0].T.contiguous(), args[1].T.contiguous())
        plain10, _ = cuda_ms(
            lambda: sqrt_smooth_plain(*sm, st_cmp[2], st_cmp[3], st_cmp[0],
                                      st_cmp[1], want_cov=want_cov),
            reps=1, warm=0)
        ms10, _ = cuda_ms(
            lambda: sqrt_smooth(*sm, st[2], st[3], st[0], st[1],
                                want_cov=want_cov), reps=3, warm=1)
        bms, bby = bound_ms(*k10_cost(st[1], want_cov, 4), "float32")
        times[f"sqrt_smooth{key}"] = {
            "shape": f"{label}, {'with' if want_cov else 'without'} "
                     "covariance", "ms": ms10, "plain_ms": plain10,
            "plain_shape": plain_shape, "bound_ms": bms, "bound_by": bby}
        if lanes == 1:  # the deviance's carry-only pass
            plain9c, _ = cuda_ms(lambda: sqrt_filter_plain(*cmp), reps=1,
                                 warm=0)
            ms9c, _ = cuda_ms(lambda: sqrt_filter(*args), reps=3, warm=1)
            bms, bby = bound_ms(*k9_cost(args[2], args[5], args[6], False,
                                         False, 4), "float32")
            times["sqrt_filter_carry"] = {
                "shape": f"{label}, carry only", "ms": ms9c,
                "plain_ms": plain9c, "plain_shape": plain_shape,
                "bound_ms": bms, "bound_by": bby}
    # the serving history pass (512 lanes, carry only) and update (k=1)
    *args, _ = lanes_case(rng, FLEET, T_STEPS, dtype, dev)
    t_pl = 50
    cmp = short_args(args, t_pl)
    plain_h, _ = cuda_ms(lambda: sqrt_filter_plain(*cmp), reps=1, warm=0)
    ms_h, _ = cuda_ms(lambda: sqrt_filter(*args), reps=3, warm=1)
    bms, bby = bound_ms(*k9_cost(args[2], args[5], args[6], False, False,
                                 4), "float32")
    times["sqrt_filter_history"] = {
        "shape": f"{FLEET} lanes, n=21 T={T_STEPS} f32, carry only",
        "ms": ms_h, "plain_ms": plain_h,
        "plain_shape": f"{FLEET} lanes, T={t_pl}, once",
        "bound_ms": bms, "bound_by": bby}
    case = sqrt_bucket_case(rng, FLEET, dtype, dev)
    plain_u, _ = cuda_ms(lambda: sqrt_filter_plain(
        *case[:7], mean0=case[7], chol0=case[8]), reps=1, warm=0)
    ms_u, _ = cuda_ms(lambda: sqrt_filter(*case[:7], mean0=case[7],
                                          chol0=case[8]), reps=20, warm=2)
    lane_map = torch.arange(FLEET, dtype=torch.int32, device=dev)
    bms, bby = bound_ms(*k9_cost(case[2], case[5], lane_map, False, True,
                                 4), "float32")
    times["sqrt_filter_update"] = {
        "shape": f"serving bucket {BUCKET}, {FLEET} slots, k=1, f32, "
                 "given carry", "ms": ms_u, "plain_ms": plain_u,
        "plain_shape": f"{FLEET} slots, k=1, once",
        "bound_ms": bms, "bound_by": bby}
    emit({"phase": "sqrt_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar", "ok")}
        for c in checks], "times": times})
    bad_checks = [c for c in checks if not c["ok"]]
    require(not bad_checks,
            f"kernel disagrees with its plain version: {bad_checks}")
    more_checks, more_times = k9_group_vs_block(dev)
    bad_checks = [c for c in more_checks if not c["ok"]]
    require(not bad_checks,
            f"kernel disagrees with its plain version: {bad_checks}")
    times.update(more_times)
    return checks + more_checks, times


ADJ_SEG = 128  # the batch-layout adjoint's segment (DEFAULT_SEG)
ADJ_T = 300  # steps of the small K11 and bounds checks (3 segments)


def _adjoint_case(rng, b, t, dtype, dev, degraded=False):
    """``(ss, y, mask)`` of ``b`` flagship-width models (leaves leading
    with B) over ``t`` steps, a fully masked step and, with ``degraded``,
    model 0 observing a slot with r < 0 (its updates degrade)."""
    import numpy as np
    import torch

    from metran_tpu_torch.ops import dfm_statespace

    y, mask, lds, a_s, a_c = make_workload(rng, b, t=t)
    mask = mask.copy()
    mask[:, 3] = False
    ss = dfm_statespace(a_s, a_c, lds, 1.0, device=dev, dtype=dtype)
    if degraded:
        r = ss.r.clone()
        r[0, 2] = -5.0
        ss = ss._replace(r=r)
    return (ss, torch.as_tensor(np.where(mask, y, 0.0), dtype=dtype,
                                device=dev), torch.as_tensor(mask, device=dev))


def _boundaries(engine, ss, y, mask, seg):
    """The segment boundaries the adjoint's forward keeps for ``engine``
    (K1 ``bounds``, K9 ``bounds`` or K3 ``keep_bounds``): ``(bounds_mean
    (B, n_seg, n), bounds (B, n_seg, n, n), factored)``."""
    import torch

    from metran_tpu_torch.kernels.joint_filter import joint_filter_append
    from metran_tpu_torch.kernels.lanes import lanes_filter
    from metran_tpu_torch.kernels.sqrt_filter import sqrt_filter

    b, n = ss.phi.shape
    qd = torch.diagonal(ss.q, 0, -2, -1)
    if engine == "joint":
        out = joint_filter_append(
            ss.phi, ss.q, ss.z, ss.r, ss.phi.new_zeros((b, n)),
            torch.eye(n, dtype=ss.phi.dtype, device=ss.phi.device).expand(
                b, n, n).contiguous(), y, mask, bounds_seg=seg)
        return out[4], out[5], False
    lanes = (ss.phi.T.contiguous(), qd.T.contiguous(),
             ss.z.permute(1, 2, 0).contiguous(), ss.r.T.contiguous(), y,
             mask)
    if engine == "sqrt":
        out = sqrt_filter(*lanes, bounds_seg=seg)
        return out[4], out[5], True
    res = lanes_filter(*lanes, seg=seg, keep_bounds=True)
    return (res.bounds_mean.permute(2, 0, 1).contiguous(),
            res.bounds_cov.permute(3, 0, 1, 2).contiguous(), False)


ADJ_RING_SEG = 16  # the segment of K11's ring cases (short, many segments)
# K11's ring cases: (models, steps, widths (N, factors), options); the
# flagship widths unless stated.  ADJ_RING_T wraps a ring of RING_MAX
# slots (ring_depth's at these widths) with five steps to spare.
ADJ_RING_T = 4 * ADJ_RING_SEG + 5
ADJ_RING_CASES = (
    ("B=1 T=1", 1, 1, (N_SERIES, N_FACTORS), {}),
    ("B=3 T=seg-1", 3, ADJ_RING_SEG - 1, (N_SERIES, N_FACTORS), {}),
    ("B=3 T=seg", 3, ADJ_RING_SEG, (N_SERIES, N_FACTORS), {}),
    ("B=133 T=4 seg+5 (the ring wraps, compact block)", 133, ADJ_RING_T,
     (N_SERIES, N_FACTORS), {}),
    ("B=3 T=4 seg+5 (the ring wraps, wide block)", 3, ADJ_RING_T,
     (N_SERIES, N_FACTORS), {}),
    ("B=3 T=4 seg+5 (the ring wraps, wide block), factor boundaries", 3,
     ADJ_RING_T, (N_SERIES, N_FACTORS), {"factored": True}),
    ("B=3, a fully masked segment", 3, 3 * ADJ_RING_SEG + 2,
     (N_SERIES, N_FACTORS), {"masked_seg": True}),
    ("B=3, degraded steps mid-segment", 3, 2 * ADJ_RING_SEG + 7,
     (N_SERIES, N_FACTORS), {"degraded": True}),
    ("B=3, degraded steps mid-segment, factor boundaries", 3,
     2 * ADJ_RING_SEG + 7, (N_SERIES, N_FACTORS),
     {"degraded": True, "factored": True}),
    ("B=3 N=40 n=41 (rows of F per lane > 1)", 3, 2 * ADJ_RING_SEG + 5,
     (40, 1), {}),
    ("B=2 N=45 n=46 (f64: the device-memory layout)", 2,
     2 * ADJ_RING_SEG + 5, (45, 1), {}),
    # more models than the card keeps resident in the wide block
    ("B=133 N=40 n=41 (the compact block)", 133, 2 * ADJ_RING_SEG + 5,
     (40, 1), {}),
    ("B=133 N=45 n=46 (the compact block; f64 spills)", 133,
     ADJ_RING_SEG + 3, (45, 1), {}),
)


def _adjoint_ring_case(rng, b, t, widths, dtype, dev, masked_seg=False,
                       degraded=False, factored=False):
    """K11's arguments for a ring case: ``b`` models of ``widths`` =
    (series, factors) over ``t`` steps with boundaries every
    ADJ_RING_SEG steps from K1 (or, ``factored``, K9), an all-masked
    step, optionally a fully masked second segment and model 0's slot 2
    at r < 0 observed only at a few steps in the middle of the first
    segment (those steps degrade)."""
    import numpy as np
    import torch

    from metran_tpu_torch.ops import dfm_statespace

    seg = ADJ_RING_SEG
    big_n, kf = widths
    ss = dfm_statespace(rng.uniform(5, 40, (b, big_n)),
                        rng.uniform(10, 60, (b, kf)),
                        rng.uniform(0.3, 0.8, (b, big_n, kf)) / kf, 1.0,
                        device=dev, dtype=dtype)
    mask = rng.uniform(size=(b, t, big_n)) > 0.3
    if t > 3:
        mask[:, 3] = False
    if masked_seg:
        mask[:, seg:2 * seg] = False
    r = torch.full_like(ss.r, 0.2)
    if degraded:
        r[0, 2] = -5.0
        mask[0, :, 2] = False
        mask[0, np.arange(seg // 3, min(t, 2 * seg // 3), 3), 2] = True
    ss = ss._replace(r=r)
    y = torch.as_tensor(np.where(mask, rng.normal(size=mask.shape), 0.0),
                        dtype=dtype, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    bm, bc, _ = _boundaries("sqrt" if factored else "joint", ss, y, mask,
                            seg)
    sb = torch.as_tensor(rng.uniform(0.5, 1.5, (b, t)), dtype=dtype,
                         device=dev)
    db = torch.as_tensor(rng.uniform(0.5, 1.5, (b, t)), dtype=dtype,
                         device=dev)
    return (ss.phi, torch.diagonal(ss.q, 0, -2, -1).contiguous(), ss.z,
            ss.r, y, mask, bm, bc, sb, db, seg, factored)


def phase_adjoint_kernels():
    """K11 (the batch-layout adjoint) against its plain version on the
    card, f64 and f32, NaN-strict: at flagship widths (n = 21, N = 20)
    over ADJ_T steps for each engine's boundaries (K1 ``bounds``, K9
    ``bounds`` — a factor, entered as S S' — and K3 ``keep_bounds``),
    with a fully masked step and, on the covariance and factor
    boundaries, a model observing a slot with r < 0; then at the
    flagship shape (512 models) over the first ADJ_T_CMP steps.  K1 and K9
    ``bounds``: the per-step terms and the final carry equal the
    carry-only instantiation's bit for bit, and each boundary equals the
    carry-only kernel run to that segment's start, bit for bit.  The
    anchored adjoint from a non-triangular anchor: its value is the
    score of ``sqrt_filter_append``'s K9 call, bit for bit, and its
    gradient the CPU f64 plain path's.  An independent check in f64:
    K11's gradient of the K1 deviance against central differences (rel
    1e-6).  Then K11 and the two ``bounds`` modes timed at the full
    flagship shape beside their bounds."""
    import numpy as np
    import torch

    import importlib

    from metran_tpu_torch.kernels import launches
    from metran_tpu_torch.kernels.joint_adjoint import (
        joint_adjoint,
        joint_adjoint_plain,
    )
    from metran_tpu_torch.kernels.joint_filter import (
        joint_filter_append,
        joint_filter_append_plain,
    )
    from metran_tpu_torch.kernels.sqrt_filter import (
        sqrt_filter,
        sqrt_filter_plain,
    )
    from metran_tpu_torch.ops import (
        anchored_adjoint_deviance,
        deviance,
        dfm_statespace,
        sqrt_filter_append,
    )

    k11 = importlib.import_module("metran_tpu_torch.kernels.joint_adjoint")
    dev = torch.device(DEVICE)
    checks = []

    def compare(kernel, case, dtype, got, want, bar):
        checks.append(check_entry(kernel, case, dtype, got, want, bar))

    def cotangents(rng, shape, dtype):
        return (torch.as_tensor(rng.uniform(0.5, 1.5, shape), dtype=dtype,
                                device=dev),
                torch.as_tensor(rng.uniform(0.5, 1.5, shape), dtype=dtype,
                                device=dev))

    # K11 against its plain version over each engine's boundaries
    for dtype, bar in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        for engine in ("joint", "sqrt", "sequential"):
            rng = np.random.default_rng(SEED + 90)
            ss, y, mask = _adjoint_case(rng, 8, ADJ_T, dtype, dev,
                                        degraded=engine != "sequential")
            bm, bc, factored = _boundaries(engine, ss, y, mask, ADJ_SEG)
            sb, db = cotangents(rng, y.shape[:2], dtype)
            args = (ss.phi, torch.diagonal(ss.q, 0, -2, -1).contiguous(),
                    ss.z, ss.r, y, mask, bm, bc, sb, db, ADJ_SEG, factored)
            got = joint_adjoint(*args)
            want = joint_adjoint_plain(*args)
            torch.cuda.synchronize()
            compare("joint_adjoint", f"8 models n=21 T={ADJ_T} seg="
                    f"{ADJ_SEG}, {engine} boundaries"
                    + ("" if engine == "sequential" else
                       ", model 0 degraded (r < 0)"), dtype, got, want, bar)
    # the ring's cases: short and exact-multiple horizons, a ring that
    # wraps, a masked segment, degraded steps mid-segment, factor
    # boundaries, F of more rows than a warp's lanes, the spilled layout;
    # one launch per call
    for dtype, bar in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        for label, b, t, widths, kw in ADJ_RING_CASES:
            rng = np.random.default_rng(SEED + 96)
            args = _adjoint_ring_case(rng, b, t, widths, dtype, dev, **kw)
            if "wraps" in label:  # the ring wraps in the block named
                n_st = args[0].shape[1]
                ring, spill = k11.ring_depth(widths[0], n_st, dtype,
                                             -(-t // ADJ_RING_SEG))
                shape = k11.block_shape(b, widths[0], n_st, dtype, ring,
                                        spill, dev)
                require(ring == k11.RING_MAX and ring < -(-t // ADJ_RING_SEG)
                        and shape == (k11.WIDE if "wide" in label
                                      else k11.COMPACT),
                        f"K11 {label}: ring {ring}, block {shape}")
            before = launches()["joint_adjoint"]
            got = joint_adjoint(*args)
            one = launches()["joint_adjoint"] - before
            want = joint_adjoint_plain(*args)
            torch.cuda.synchronize()
            require(one == 1, f"K11 {label}: {one} launches, not 1")
            compare("joint_adjoint", f"{label}, seg={ADJ_RING_SEG}", dtype,
                    got, want, bar)
    dtype = torch.float32
    rng = np.random.default_rng(SEED + 91)
    ss, y, mask = _adjoint_case(rng, FLEET, ADJ_T_CMP, dtype, dev)
    bm, bc, _ = _boundaries("joint", ss, y, mask, ADJ_SEG)
    sb, db = cotangents(rng, y.shape[:2], dtype)
    args = (ss.phi, torch.diagonal(ss.q, 0, -2, -1).contiguous(), ss.z,
            ss.r, y, mask, bm, bc, sb, db, ADJ_SEG, False)
    got = joint_adjoint(*args)
    plain_ms, want = cuda_ms(lambda: joint_adjoint_plain(*args), reps=1,
                             warm=0)
    compare("joint_adjoint", f"{FLEET} models n=21 T={ADJ_T_CMP} "
            f"seg={ADJ_SEG}, joint boundaries (the flagship shape)", dtype,
            got, want, 1e-3)
    times = {"joint_adjoint_plain_ms": plain_ms}

    # K1 and K9 bounds: bit for bit the carry instantiations
    bitwise = []
    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(SEED + 92)
        ss, y, mask = _adjoint_case(rng, 16, ADJ_T_CMP, dtype, dev)
        b, n = ss.phi.shape
        m0 = ss.phi.new_zeros((b, n))
        c0 = torch.eye(n, dtype=dtype, device=dev).expand(b, n, n)
        c0 = c0.contiguous()
        lanes = (ss.phi.T.contiguous(),
                 torch.diagonal(ss.q, 0, -2, -1).T.contiguous(),
                 ss.z.permute(1, 2, 0).contiguous(), ss.r.T.contiguous())
        for kernel, run in (
                ("joint_filter_append", lambda yy, mm, seg=None:
                 joint_filter_append(ss.phi, ss.q, ss.z, ss.r, m0, c0, yy,
                                     mm, bounds_seg=seg)),
                ("sqrt_filter", lambda yy, mm, seg=None:
                 sqrt_filter(*lanes, yy.contiguous(), mm.contiguous(),
                             bounds_seg=seg))):
            carry = run(y, mask)
            bnd = run(y, mask, ADJ_SEG)
            same = all(torch.equal(a, c) for a, c in zip(carry, bnd[:4]))
            for k in range(1, bnd[4].shape[1]):
                pre = run(y[:, :k * ADJ_SEG], mask[:, :k * ADJ_SEG])
                same = (same and torch.equal(pre[0], bnd[4][:, k])
                        and torch.equal(pre[1], bnd[5][:, k]))
            torch.cuda.synchronize()
            bitwise.append({"kernel": kernel,
                            "dtype": str(dtype).replace("torch.", ""),
                            "case": f"16 models T={ADJ_T_CMP} seg={ADJ_SEG}",
                            "bitwise": bool(same)})
    emit({"phase": "bounds_bitwise", "checks": bitwise})
    require(all(c["bitwise"] for c in bitwise),
            f"a bounds instantiation is not its carry instantiation: "
            f"{bitwise}")

    # the anchored adjoint from a non-triangular anchor (f64): the value
    # is sqrt_filter_append's score, the gradient the CPU plain path's
    rng = np.random.default_rng(SEED + 93)
    y, mask, lds, a_s, a_c = make_workload(rng, 8, t=ADJ_T)
    alpha = np.concatenate([a_s, a_c], axis=1)
    anchor = sqrt_filter_append(
        dfm_statespace(a_s, a_c, lds, 1.0, device="cpu"),
        np.zeros((8, N_SERIES + 1)),
        np.broadcast_to(np.eye(N_SERIES + 1), (8, N_SERIES + 1,
                                              N_SERIES + 1)),
        np.where(mask, y, 0.0)[:, :100], mask[:, :100], device="cpu")
    rot = np.linalg.qr(rng.normal(size=(N_SERIES + 1, N_SERIES + 1)))[0]
    m_a, c_a = anchor[0].numpy(), anchor[1].numpy() @ rot  # not triangular
    tail = (np.where(mask, y, 0.0)[:, 100:], mask[:, 100:])
    grads, values = [], []
    for where in (dev, "cpu"):
        p = torch.tensor(alpha, dtype=torch.float64, device=where,
                         requires_grad=True)
        ss = dfm_statespace(p[:, :N_SERIES], p[:, N_SERIES:], lds, 1.0,
                            device=where)
        val = anchored_adjoint_deviance(ss, m_a, c_a, *tail, device=where)
        (g,) = torch.autograd.grad(val.sum(), p)
        grads.append(g.cpu())
        values.append(val.detach().cpu())
    ss_free = dfm_statespace(alpha[:, :N_SERIES], alpha[:, N_SERIES:], lds,
                             1.0, device=dev, dtype=torch.float64)
    _, _, sig, det = sqrt_filter_append(ss_free, m_a, c_a, *tail, device=dev)
    score = (sig.sum(-1) + det.sum(-1)).cpu()
    anchored = {"value_is_the_score": bool(torch.equal(values[0], score)),
                "value_vs_cpu": rel_err(values[0], values[1]),
                "grad_vs_cpu": rel_err(grads[0], grads[1])}
    emit({"phase": "anchored_adjoint", "models": 8, "tail": ADJ_T - 100,
          **anchored})
    require(anchored["value_is_the_score"],
            "anchored value is not sqrt_filter_append's score")
    require(anchored["value_vs_cpu"] <= 1e-9
            and anchored["grad_vs_cpu"] <= 1e-9, f"anchored: {anchored}")

    # an independent check (f64): K11's gradient of the K1 deviance
    # against central differences of the K1 deviance, all 2P points of
    # every model in one K1 launch
    rng = np.random.default_rng(SEED + 94)
    b_fd = 4
    y, mask, lds, a_s, a_c = make_workload(rng, b_fd, t=ADJ_T)
    alpha = np.concatenate([a_s, a_c], axis=1)
    n_p = alpha.shape[1]
    yt = torch.as_tensor(np.where(mask, y, 0.0), device=dev)
    mt_ = torch.as_tensor(mask, device=dev)
    p = torch.tensor(alpha, device=dev, requires_grad=True)
    val = deviance(dfm_statespace(p[:, :N_SERIES], p[:, N_SERIES:], lds,
                                  1.0, device=dev), yt, mt_, engine="joint",
                   grad="adjoint")
    (g_adj,) = torch.autograd.grad(val.sum(), p)
    h = 1e-5 * alpha
    pert = np.concatenate([alpha[:, None, :] + np.eye(n_p) * h[:, None, :],
                           alpha[:, None, :] - np.eye(n_p) * h[:, None, :]],
                          axis=1).reshape(-1, n_p)  # (B * 2P, P)
    rep = np.repeat(np.arange(b_fd), 2 * n_p)
    with torch.no_grad():
        v = deviance(dfm_statespace(pert[:, :N_SERIES], pert[:, N_SERIES:],
                                    lds[rep], 1.0, device=dev),
                     yt[rep], mt_[rep], engine="joint")
    v = v.reshape(b_fd, 2, n_p).cpu().numpy()
    g_fd = (v[:, 0] - v[:, 1]) / (2.0 * h)
    fd_err = rel_err(g_adj.cpu(), torch.as_tensor(g_fd))
    emit({"phase": "adjoint_central_difference", "models": b_fd,
          "t_steps": ADJ_T, "step": "1e-5 alpha", "rel_err": fd_err,
          "bar": 1e-6})
    require(fd_err <= 1e-6, f"K11 vs central differences: {fd_err}")

    # timed at the full flagship shape (f32) beside their bounds
    dtype = torch.float32
    rng = np.random.default_rng(SEED + 95)
    ss, y, mask = _adjoint_case(rng, FLEET, T_STEPS, dtype, dev)
    b, n = ss.phi.shape
    qd = torch.diagonal(ss.q, 0, -2, -1).contiguous()
    m0 = ss.phi.new_zeros((b, n))
    c0 = torch.eye(n, dtype=dtype, device=dev).expand(b, n, n).contiguous()
    k1_args = (ss.phi, ss.q, ss.z, ss.r, m0, c0, y, mask)
    ms1, out = cuda_ms(lambda: joint_filter_append(*k1_args,
                                                   bounds_seg=ADJ_SEG),
                       reps=3, warm=1)
    short = (*k1_args[:6], y[:, :ADJ_T_CMP], mask[:, :ADJ_T_CMP])
    plain1, _ = cuda_ms(lambda: joint_filter_append_plain(
        *short, bounds_seg=ADJ_SEG), reps=1, warm=0)
    bms, bby = bound_ms(*bounds_cost(k1_cost(ss.z, ss.q, mask, 4), b, n,
                                     T_STEPS, ADJ_SEG, 4), "float32")
    times["joint_filter_append_bounds"] = {
        "shape": f"B={FLEET} k={T_STEPS} (20,21) f32, seg={ADJ_SEG} "
                 "boundaries", "ms": ms1, "plain_ms": plain1,
        "plain_shape": f"{FLEET} models, T={ADJ_T_CMP}, once",
        "bound_ms": bms, "bound_by": bby}
    sb = torch.ones(y.shape[:2], dtype=dtype, device=dev)
    k11_args = (ss.phi, qd, ss.z, ss.r, y, mask, out[4], out[5], sb, sb,
                ADJ_SEG, False)
    ms11, _ = cuda_ms(lambda: joint_adjoint(*k11_args), reps=3, warm=1)
    bms, bby = bound_ms(*k11_cost(ss.z, mask, ADJ_SEG, 4), "float32")
    by_batch = {}
    for bb in (64, 8, 1):  # the first bb models of the same fleet
        part = [a[:bb].contiguous() for a in k11_args[:10]]
        ms_b, got_b = cuda_ms(lambda: joint_adjoint(*part, ADJ_SEG, False),
                              reps=3, warm=1)
        if bb == 64:  # a timed launch in the wide block, its ring wrapping
            compare("joint_adjoint", f"{bb} models n=21 T={T_STEPS} "
                    f"seg={ADJ_SEG}, joint boundaries (a timed launch)",
                    dtype, got_b, joint_adjoint_plain(*part, ADJ_SEG, False),
                    1e-3)
        bms_b, bby_b = bound_ms(*k11_cost(part[2], part[5], ADJ_SEG, 4),
                                "float32")
        by_batch[str(bb)] = {"ms": ms_b, "bound_ms": bms_b,
                             "bound_by": bby_b}
    n_seg = -(-T_STEPS // ADJ_SEG)
    geometry = {}
    for dt in (torch.float32, torch.float64):
        ring, spill = k11.ring_depth(N_SERIES, n, dt, n_seg)
        geometry[str(dt).replace("torch.", "")] = {
            "ring_depth": ring, "spill": spill,
            "smem_bytes": 0 if spill else k11.smem_bytes(N_SERIES, n, dt,
                                                         ring),
            "ring_bytes": int(np.prod(k11.scratch_shape(
                FLEET, T_STEPS, ADJ_SEG, N_SERIES, n, ring)))
            * (4 if dt == torch.float32 else 8),
            **{f"{name}_block": {
                "replay_warps_per_group": g, "sweep_warps": sw,
                "threads": 32 * (ring * g + sw),
                "blocks_per_sm": k11.occupancy(N_SERIES, n, dt, ring, spill,
                                               g, sw)}
               for name, (g, sw) in (("compact", k11.COMPACT),
                                     ("wide", k11.WIDE))
               if not (spill and name == "wide")},
            "block_at": {str(bb): "wide" if k11.block_shape(
                bb, N_SERIES, n, dt, ring, spill, dev) == k11.WIDE
                else "compact" for bb in (FLEET, 64, 8, 1)}}
    emit({"phase": "k11_geometry", "shape": f"B={FLEET} T={T_STEPS} "
          f"({N_SERIES},{n}) seg={ADJ_SEG}", **geometry})
    times["joint_adjoint"] = {
        "shape": f"B={FLEET} T={T_STEPS} (20,21) f32 seg={ADJ_SEG}, joint "
                 "boundaries", "ms": ms11,
        "plain_ms": times.pop("joint_adjoint_plain_ms"),
        "plain_shape": f"{FLEET} models, T={ADJ_T_CMP}, once",
        "bound_ms": bms, "bound_by": bby, "by_batch": by_batch,
        "ring_depth": geometry["float32"]["ring_depth"],
        "blocks_per_sm": {
            name: geometry["float32"][f"{name}_block"]["blocks_per_sm"]
            for name in ("compact", "wide")}}
    lanes = (ss.phi.T.contiguous(), qd.T.contiguous(),
             ss.z.permute(1, 2, 0).contiguous(), ss.r.T.contiguous(), y, mask)
    ms9, _ = cuda_ms(lambda: sqrt_filter(*lanes, bounds_seg=ADJ_SEG), reps=3,
                     warm=1)
    t_pl = 50
    plain9, _ = cuda_ms(lambda: sqrt_filter_plain(
        *lanes[:4], y[:, :t_pl], mask[:, :t_pl], bounds_seg=ADJ_SEG), reps=1,
        warm=0)
    lane_map = torch.arange(FLEET, dtype=torch.int32, device=dev)
    bms, bby = bound_ms(*bounds_cost(k9_cost(lanes[2], mask, lane_map, False,
                                             False, 4), b, n, T_STEPS,
                                     ADJ_SEG, 4), "float32")
    times["sqrt_filter_bounds"] = {
        "shape": f"{FLEET} lanes, n=21 T={T_STEPS} f32, seg={ADJ_SEG} "
                 "boundaries", "ms": ms9, "plain_ms": plain9,
        "plain_shape": f"{FLEET} lanes, T={t_pl}, once",
        "bound_ms": bms, "bound_by": bby}
    emit({"phase": "adjoint_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar", "ok")}
        for c in checks], "times": times})
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"kernel disagrees with its plain version: {bad}")
    return checks, times


# the f32 precision recipe of tests/test_precision.py (make_flagship,
# ALPHAS, DEV_RTOL), copied: that test imports JAX
PREC_N, PREC_K, PREC_T = 20, 1, 5000
# ----------------------------------------------------------------------
# the serving path's input defences: K12, gated K9, K13 and K1's store
# ----------------------------------------------------------------------
GATE_NSIGMA = 4.0  # the gate's default bar (GateSpec)
GATE_SPIKE = 30.0  # injected spikes, standardized data units
GATE_SPIKED = 64  # models of the bucket carrying one spike each


def k12_cost(z, q, mask, itemsize):
    """Bytes the K12 call must move (the model constants, the carry, the
    data and the armed flags read once; the posterior, the terms, the
    z-scores and the int8 verdicts written once) and the least
    operations this run's data needs: the predict as K1's (``phi o m``,
    ``(phi phi') o P + q`` on the upper half and q's nonzeros), then per
    observed slot ``v = y - z.m`` and ``f = z.d`` on the row's nonzeros,
    ``d = P z`` (nnz(z) per row of P), the score and its test, the gain
    ``k = d / f``, ``m += k v`` and ``P -= (k f) k'`` on the upper
    half."""
    import torch

    b, n, s = z.shape
    k = mask.shape[1]
    nbytes = (b * (2 * s + 2 * s * s + n * s + n) * itemsize + b
              + b * k * n * (itemsize + 1)
              + b * (s + s * s + 2 * k) * itemsize
              + b * k * n * (itemsize + 1))
    half = s * (s + 1) / 2
    nnz = (z != 0).double().sum(-1)  # (B, N) nonzeros per row of Z
    per_slot = 4 * nnz + 2 * nnz * s + 6 + s + 2 * s + s + 2 * half
    ops = float((mask.double() * per_slot[:, None, :]).sum())
    q_up = int(torch.triu(q != 0).sum())
    ops += b * k * (s + half) + k * q_up + b * half
    return nbytes, ops


def k13_cost(mask, itemsize):
    """Bytes the K13 call must move (the (B, 6, N) state, the z-scores,
    the mask and the armed flags read once; the state and the (B, 3, N)
    int32 counts written once) and its operations: per observed step the
    anomaly test, the two CUSUM recursions with their alarm, the three
    forgetting-factor sums and the two LB statistics (~30)."""
    b, k, n = mask.shape
    nbytes = (2 * b * 6 * n * itemsize + b * k * n * (itemsize + 1) + b
              + b * 3 * n * 4)
    return nbytes, 30.0 * float(mask.sum())


def k9_gated_cost(z, mask, lane_map, itemsize):
    """K9 from a given carry (:func:`k9_cost`) plus the gate: per
    observed slot the marginal ``|(Z S_p)_i|^2`` on the row of the
    compact pre-array the update forms anyway (2n), the z-score and its
    test; bytes plus the armed flags, the z-scores and the verdicts."""
    nbytes, ops = k9_cost(z, mask, lane_map, False, True, itemsize)
    big_n, n, lanes = z.shape
    t_steps = mask.shape[1]
    obs = float(mask[lane_map.long()].sum())
    return (nbytes + lanes + lanes * t_steps * big_n * (itemsize + 1),
            ops + obs * (2 * n + 6))


def store_cost(cost, b, s, t_steps, itemsize):
    """A carry-only filter's ``(bytes, operations)`` with its store's
    outputs: every step's (m_p, P_p, m_f, P_f) in place of the final
    carry."""
    nbytes, ops = cost
    return (nbytes + b * (t_steps * (2 * s + 2 * s * s) - (s + s * s))
            * itemsize, ops)


def _gate_case(rng, dtype, dev, k=1):
    """The flagship bucket (24, 32) warmed by 64 steps of its own data
    (K1 from N(0, I)), then ``k`` appended steps with a spike on one
    known slot of each of the first GATE_SPIKED models and an armed mix
    (every fourth model disarmed).  Returns the K1/K12 argument tuple,
    ``armed`` and the spiked (model, step, slot) cells."""
    import torch

    from metran_tpu_torch.kernels import joint_filter_append

    batch = FLEET
    phi, q, z, r, y, mask = padded_inputs(rng, batch, 64 + k, dtype, dev)
    s = phi.shape[1]
    mean0 = torch.zeros((batch, s), dtype=dtype, device=dev)
    cov0 = torch.eye(s, dtype=dtype, device=dev).expand(
        batch, s, s).contiguous()
    warm = joint_filter_append(phi, q, z, r, mean0, cov0, y[:, :64],
                               mask[:, :64])
    y_k, m_k = y[:, 64:].clone(), mask[:, 64:].clone()
    spiked = []
    for b in range(min(GATE_SPIKED, batch)):
        t, i = b % k, b % N_SERIES
        y_k[b, t, i] += GATE_SPIKE if b % 2 else -GATE_SPIKE
        m_k[b, t, i] = True
        spiked.append((b, t, i))
    armed = torch.tensor([b % 4 != 3 for b in range(batch)], device=dev)
    return ((phi, q, z, r, warm[0], warm[1], y_k.contiguous(),
             m_k.contiguous()), armed, spiked)


def phase_gate_kernels():
    """K12 (the gated sequential update, each policy), K9's gated
    instantiation and K13 (the detector) against their plain versions on
    the card, f64 and f32 (normwise 1e-9 / 1e-3, NaN-strict, verdicts
    and counts equal), on the flagship bucket (B = 512, (24, 32)) with
    spikes on known slots and an armed mix; the two bit-exactness
    contracts (K12 armed but never tripping = K12 ``off``; gated K9
    never tripping = K9's given-carry run); K1's ``store`` against its
    history pass (the terms and the last step bitwise, every stored
    filtered step bitwise K1's one-step carry from the step before, 16
    models; the plain store over T_CMP steps).  Then each timed at the
    main path's shapes in f32 beside its bound."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import (
        detect_scan,
        detect_scan_plain,
        gated_filter_append,
        gated_filter_append_plain,
        joint_filter_append,
        joint_filter_store,
        joint_filter_store_plain,
        sqrt_filter,
        sqrt_filter_gated,
        sqrt_filter_gated_plain,
    )
    from metran_tpu_torch.ops import chol_outer, dfm_statespace
    from metran_tpu_torch.ops.kalman import _lanes_ss
    from metran_tpu_torch.ops.statespace import StateSpace

    dev = torch.device(DEVICE)
    thresh = GATE_NSIGMA ** 2
    checks, times, contracts = [], {}, {}

    def record(kernel, case, dtype, got, want, bar, exact=()):
        """One check: normwise errors of the float outputs, equality of
        the ``exact`` (integer) ones."""
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        same = [bool(torch.equal(got[i], want[i])) for i in exact]
        checks.append({
            "kernel": kernel, "case": case, "dtype": str(dtype)[6:],
            "rel_err": errs, "bar": bar, "exact_equal": same,
            "max_abs_err": max(abs_err(g, w) for g, w in zip(got, want)),
            "ok": within(errs, bar) and all(same)})

    def lanes_of(args):
        phi, q, z, r = _lanes_ss(StateSpace(*args[:4]), "sqrt")
        return phi, q, z, r, args[6], args[7]

    for dtype in (torch.float64, torch.float32):
        bar = 1e-9 if dtype == torch.float64 else 1e-3
        rng = np.random.default_rng(SEED + 90)
        args, armed, spiked = _gate_case(rng, dtype, dev)
        off = gated_filter_append(*args, armed, "off", 0.0)
        for policy in ("off", "reject", "huber", "inflate"):
            got = gated_filter_append(*args, armed, policy, thresh)
            want = gated_filter_append_plain(*args, armed, policy, thresh)
            torch.cuda.synchronize()
            record("gated_filter", f"{policy}, B={FLEET} k=1 (24, 32)",
                   dtype, got[:5], want[:5], bar)
            record("gated_filter", f"{policy} verdicts", dtype,
                   [got[5].double()], [want[5].double()], 0.0, exact=(0,))
            padded = got[4][:, :, N_SERIES:]
            require(torch.isnan(padded).all()
                    and not got[5][:, :, N_SERIES:].any(),
                    f"K12 {policy}: a padded slot was scored or gated")
            if policy != "off":
                caught = [int(got[5][b, t, i]) for b, t, i in spiked]
                require(all(c != 0 for (b, _, _), c in zip(spiked, caught)
                            if b % 4 != 3),
                        f"K12 {policy}: an armed spike passed the gate")
                require(all(c == 0 for (b, _, _), c in zip(spiked, caught)
                            if b % 4 == 3),
                        f"K12 {policy}: a disarmed model was gated")
                never = gated_filter_append(*args, armed, policy,
                                            float("inf"))
                torch.cuda.synchronize()
                same = all(torch.equal(a, b)
                           for a, b in zip(never[:4], off[:4]))
                contracts[f"K12 {policy} never trips == off, "
                          f"{str(dtype)[6:]}"] = same
                require(same and not never[5].any(),
                        f"K12 {policy} armed but never tripping is not "
                        "the off update bit for bit")
        # K9 gated from the warm carry, its covariance given as a factor
        # that is not triangular (as a migrated state's is)
        lanes = lanes_of(args)
        m0, c0 = args[4].contiguous(), _psd_factor(args[5])
        base = sqrt_filter(*lanes, mean0=m0, chol0=c0)
        for policy in ("reject", "huber", "inflate"):
            got = sqrt_filter_gated(*lanes, m0, c0, armed, policy, thresh)
            want = sqrt_filter_gated_plain(*lanes, m0, c0, armed, policy,
                                           thresh)
            torch.cuda.synchronize()
            record("sqrt_filter_gated", f"{policy}, B={FLEET} k=1",
                   dtype, (got[0], chol_outer(got[1]), *got[2:5]),
                   (want[0], chol_outer(want[1]), *want[2:5]), bar)
            record("sqrt_filter_gated", f"{policy} verdicts", dtype,
                   [got[5].double()], [want[5].double()], 0.0, exact=(0,))
            caught = [int(got[5][bb, t, i]) for bb, t, i in spiked]
            require(all(c != 0 for (bb, _, _), c in zip(spiked, caught)
                        if bb % 4 != 3),
                    f"gated K9 {policy}: an armed spike passed the gate")
            never = sqrt_filter_gated(*lanes, m0, c0, armed, policy,
                                      float("inf"))
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(never[:4], base))
            contracts[f"K9 gated {policy} never trips == K9, "
                      f"{str(dtype)[6:]}"] = same
            require(same, f"gated K9 {policy} never tripping is not K9 "
                    "from the given carry bit for bit")
        # K13 over a stream of z-scores with shifts, drift and gaps
        g = torch.Generator(device=dev).manual_seed(SEED + 91)
        kd = 200
        zs = torch.randn((FLEET, kd, 24), generator=g, device=dev,
                         dtype=dtype)
        zs[:, 100:, 0] += 2.5
        zs[:, 1:, 1] = 0.2 * zs[:, 1:, 1] + 0.98 * zs[:, :-1, 1]
        dmask = torch.rand((FLEET, kd, 24), generator=g, device=dev) > 0.1
        dmask[:, :, N_SERIES:] = False
        zs = torch.where(dmask, zs, torch.full_like(zs, float("nan")))
        darmed = torch.tensor([b % 8 != 7 for b in range(FLEET)],
                              device=dev)
        state0 = torch.zeros((FLEET, 6, 24), dtype=dtype, device=dev)
        kw = dict(cusum_h=8.0, lb_window=32, lb_thresh=9.0, nsigma=3.0)
        got = detect_scan(state0, zs, dmask, darmed, **kw)
        want = detect_scan_plain(state0, zs, dmask, darmed, **kw)
        torch.cuda.synchronize()
        record("detect", f"B={FLEET} k={kd} N=24", dtype, [got[0]],
               [want[0]], bar)
        record("detect", "counts", dtype, [got[1].double()],
               [want[1].double()], 0.0, exact=(0,))
        require(bool(got[1].sum(dim=(0, 2)).gt(0).all()),
                "K13: some alarm kind never fired")
        # K1's store against its carry-only history pass (16 models here;
        # the flagship fleet in the timing below)
        rng = np.random.default_rng(SEED + 92)
        yh, mh, lds, a_s, a_c = make_workload(rng, 16, t=T_CMP)
        ss = dfm_statespace(a_s, a_c, lds, 1.0, device=dev, dtype=dtype)
        sh = ss.phi.shape[1]
        hist = (*ss, torch.zeros((16, sh), dtype=dtype, device=dev),
                torch.eye(sh, dtype=dtype, device=dev).expand(
                    16, sh, sh).contiguous(),
                torch.as_tensor(yh, dtype=dtype, device=dev),
                torch.as_tensor(mh, device=dev))
        st = joint_filter_store(*hist)
        carry = joint_filter_append(*hist)
        plain = joint_filter_store_plain(*hist)
        torch.cuda.synchronize()
        record("joint_filter_store", f"B=16 T={T_CMP} (20, 21)", dtype,
               st, plain, bar)
        contracts[f"K1 store == K1 history, {str(dtype)[6:]}"] = same = (
            _store_is_carry(joint_filter_append, hist, st, carry))
        require(same, "K1 store is not K1's carry at every step")
    for c in checks:
        emit({"phase": "kernel_check", **c})
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"kernel disagrees with its plain version: {bad}")

    # the main path's shapes, f32: the update dispatch (B = 512, k = 1,
    # the bucket (24, 32)), the detector after it, K1's store over the
    # flagship history
    dtype = torch.float32
    rng = np.random.default_rng(SEED + 93)
    args, armed, _ = _gate_case(rng, dtype, dev)
    lanes = lanes_of(args)
    m0, c0 = args[4].contiguous(), _psd_factor(args[5])

    def timed(key, label, fn, plain, cost, reps=20, plain_reps=5):
        ms, _ = cuda_ms(fn, reps=reps)
        plain_ms, _ = cuda_ms(plain, reps=plain_reps, warm=1)
        bms, bby = bound_ms(*cost, "float32")
        times[key] = {"shape": label, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bms, "bound_by": bby}

    n, s = args[2].shape[1:]
    for policy in ("reject", "off", "huber", "inflate"):
        key = "gated_filter" if policy == "reject" else \
            f"gated_filter_{policy}"
        timed(key, f"{policy}, B={FLEET} k=1 N={n} S={s} f32 "
              "(update dispatch)",
              lambda p=policy: gated_filter_append(*args, armed, p, thresh),
              lambda p=policy: gated_filter_append_plain(*args, armed, p,
                                                         thresh),
              k12_cost(args[2], args[1], args[7], 4))
    timed("sqrt_filter_gated", f"reject, B={FLEET} k=1 N={n} n={s} f32 "
          "(update dispatch)",
          lambda: sqrt_filter_gated(*lanes, m0, c0, armed, "reject",
                                    thresh),
          lambda: sqrt_filter_gated_plain(*lanes, m0, c0, armed, "reject",
                                          thresh),
          k9_gated_cost(lanes[2], lanes[5], torch.arange(
              FLEET, dtype=torch.int32, device=dev), 4))
    zs1 = gated_filter_append(*args, armed, "reject", thresh)[4]
    st0 = torch.zeros((FLEET, 6, n), dtype=dtype, device=dev)
    timed("detect", f"B={FLEET} k=1 N={n} f32 (after the update)",
          lambda: detect_scan(st0, zs1, args[7], armed),
          lambda: detect_scan_plain(st0, zs1, args[7], armed),
          k13_cost(args[7], 4))
    yh, mh, lds, a_s, a_c = make_workload(np.random.default_rng(SEED + 4),
                                          FLEET)
    ss = dfm_statespace(a_s, a_c, lds, 1.0, device=dev, dtype=dtype)
    sh = ss.phi.shape[1]
    hist = (*ss, torch.zeros((FLEET, sh), dtype=dtype, device=dev),
            torch.eye(sh, dtype=dtype, device=dev).expand(
                FLEET, sh, sh).contiguous(),
            torch.as_tensor(yh, dtype=dtype, device=dev),
            torch.as_tensor(mh, device=dev))
    ms, st = cuda_ms(lambda: joint_filter_store(*hist), reps=3, warm=1)
    carry = joint_filter_append(*hist)
    same = _store_is_carry(joint_filter_append, hist, st, carry, models=16)
    contracts["K1 store == K1 history, flagship B=512 T=5000 f32"] = same
    require(same, "K1 store at the flagship shape is not K1's carry")
    del st
    short = tuple(a[:, :T_CMP] if i >= 6 else a
                  for i, a in enumerate(hist))
    plain_ms, _ = cuda_ms(lambda: joint_filter_store_plain(*short), reps=1,
                          warm=0)
    bms, bby = bound_ms(*store_cost(k1_cost(hist[2], hist[1], hist[7], 4),
                                    FLEET, sh, T_STEPS, 4), "float32")
    times["joint_filter_store"] = {
        "shape": f"B={FLEET} k={T_STEPS} N={N_SERIES} S={sh} f32 "
                 "(the joint store of the fleet's history)",
        "ms": ms, "plain_ms": plain_ms, "plain_shape":
        f"the first {T_CMP} steps, once", "bound_ms": bms, "bound_by": bby}
    torch.cuda.empty_cache()
    emit({"phase": "gate_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar",
                           "ok")} for c in checks],
        "bitwise_contracts": contracts, "times": times})
    return checks, times


def _psd_factor(cov):
    """A factor ``F F' = cov`` of PSD matrices (leading batch axis) from
    their eigendecompositions, negative roundoff eigenvalues clipped."""
    import torch

    w, v = torch.linalg.eigh((cov + cov.transpose(-1, -2)) * 0.5)
    return (v * torch.sqrt(torch.clamp(w, min=0.0))[:, None, :]).contiguous()


def _store_is_carry(k1, hist, st, carry, models=None):
    """Whether K1's store is its carry instantiation at every step: the
    terms and the last step equal the history pass's bit for bit, and
    every stored filtered step equals K1's one-step carry from the stored
    step before it (the first ``models`` models; all by default)."""
    import torch

    ok = (torch.equal(st[4], carry[2]) and torch.equal(st[5], carry[3])
          and torch.equal(st[2][:, -1], carry[0])
          and torch.equal(st[3][:, -1], carry[1]))
    sel = slice(None) if models is None else slice(0, models)
    phi, q, z, r, _, _, y, mask = (a[sel] for a in hist)
    b, k, s = st[2][sel].shape

    def rep(t):
        return t[:, None].expand(b, k - 1, *t.shape[1:]).reshape(
            b * (k - 1), *t.shape[1:]).contiguous()

    one = k1(rep(phi), rep(q), rep(z), rep(r),
             st[2][sel, :-1].reshape(-1, s).contiguous(),
             st[3][sel, :-1].reshape(-1, s, s).contiguous(),
             y[:, 1:].reshape(-1, 1, y.shape[-1]).contiguous(),
             mask[:, 1:].reshape(-1, 1, mask.shape[-1]).contiguous())
    torch.cuda.synchronize()
    return bool(ok and torch.equal(one[0], st[2][sel, 1:].reshape(-1, s))
                and torch.equal(one[1],
                                st[3][sel, 1:].reshape(-1, s, s)))


# ----------------------------------------------------------------------
# the robust (implicit-MAP) updates: K12's and K9's robust modes
# ----------------------------------------------------------------------
ROBUST_LIKELIHOODS = ("censored", "quantized", "huber_t")
ROBUST_SCALE = 0.05  # RobustSpec's default likelihood scale
# huber_t's scale in the checks: at 0.05 more than half of the Student-t
# solves stop at their step cap, where a result is not reproducible to
# the roundoff (1 ulp of input moves a f64 posterior by ~1e-6, a f32 one
# by its own size); at 0.5 every solve converges (reported beside it)
ROBUST_T_SCALE = 0.5
ROBUST_RAIL_Q = 0.05  # censored: the share of readings beyond each rail
ROBUST_QUANTUM = 0.1  # quantized: the grid, in series standard deviations
ROBUST_SPIKED = 32  # huber_t: spiked (model, slot) cells
ROBUST_SPIKE_SD = 10.0  # their size, in one-step predictive sds
# least operations of one likelihood evaluation (value, first and second
# derivative), each elementary function counted as one
ROBUST_EVAL_OPS = {"censored": 30, "quantized": 75, "huber_t": 25}


def robust_cost(cost, verdict, iters, likelihood, itemsize):
    """A gated update's ``(bytes, operations)`` (:func:`k12_cost` or
    :func:`k9_gated_cost`) with the robust mode's extra traffic (the four
    (B, N) per-slot parameters read, the (B, k, N) int32 iterations
    written) and work: per flagged slot its likelihood evaluations at the
    steps this run's data took (``iters + 1``), the Newton step's ~10
    operations each, and the MAP update's scalars (~12)."""
    nbytes, ops = cost
    b, k, n = verdict.shape
    flagged = verdict != 0
    evals = float((iters.double() + 1.0)[flagged].sum())
    return (nbytes + 4 * b * n * itemsize + 4 * b * k * n,
            ops + evals * (ROBUST_EVAL_OPS[likelihood] + 10)
            + 12.0 * float(flagged.sum()))


def _robust_case(rng, dtype, dev, likelihood, k=1,
                 t_scale=ROBUST_T_SCALE):
    """The flagship bucket (24, 32) warmed by 64 steps of its own data
    (K1 from N(0, I)), then ``k`` appended steps of its continuation as
    the likelihood's sensor reports them: clipped at rails that about
    ROBUST_RAIL_Q of the readings reach on each side (censored), rounded
    to a grid of ROBUST_QUANTUM (quantized), or with spikes of
    ROBUST_SPIKE_SD predictive sds on ROBUST_SPIKED known cells
    (huber_t); every fourth model disarmed.  Returns the K12 argument
    tuple, ``armed``, the (B, N) ``(rail_lo, rail_hi, quantum, scale)``
    and the spiked (model, step, slot) cells."""
    import torch

    from metran_tpu_torch.kernels import joint_filter_append

    batch = FLEET
    phi, q, z, r, y, mask = padded_inputs(rng, batch, 64 + k, dtype, dev)
    s = phi.shape[1]
    mean0 = torch.zeros((batch, s), dtype=dtype, device=dev)
    cov0 = torch.eye(s, dtype=dtype, device=dev).expand(
        batch, s, s).contiguous()
    warm = joint_filter_append(phi, q, z, r, mean0, cov0, y[:, :64],
                               mask[:, :64])
    y_k, m_k = y[:, 64:].clone(), mask[:, 64:].clone()
    n = y.shape[-1]
    full = dict(dtype=dtype, device=dev)
    lo = torch.full((batch, n), -float("inf"), **full)
    hi = torch.full((batch, n), float("inf"), **full)
    quantum = torch.ones((batch, n), **full)
    spiked = []
    if likelihood == "censored":
        obs = y_k[m_k].double()
        lo[:], hi[:] = (float(obs.quantile(ROBUST_RAIL_Q)),
                        float(obs.quantile(1.0 - ROBUST_RAIL_Q)))
        y_k = torch.minimum(torch.maximum(y_k, lo[:, None]), hi[:, None])
    elif likelihood == "quantized":
        quantum[:, :N_SERIES] = ROBUST_QUANTUM
        y_k = ROBUST_QUANTUM * torch.round(y_k / ROBUST_QUANTUM)
    else:
        p_pred = phi[:, :, None] * warm[1] * phi[:, None, :] + q
        sd = torch.sqrt(torch.einsum("bis,bst,bit->bi", z, p_pred, z) + r)
        for b in range(min(ROBUST_SPIKED, batch)):
            t, i = b % k, b % N_SERIES
            sign = 1.0 if b % 2 else -1.0
            y_k[b, t, i] += sign * ROBUST_SPIKE_SD * sd[b, i]
            m_k[b, t, i] = True
            spiked.append((b, t, i))
    scale = torch.full((batch, n), t_scale if likelihood == "huber_t"
                       else ROBUST_SCALE, **full)
    armed = torch.tensor([b % 4 != 3 for b in range(batch)], device=dev)
    return ((phi, q, z, r, warm[0], warm[1], y_k.contiguous(),
             m_k.contiguous()), armed, (lo, hi, quantum, scale), spiked)


def _verdict_check(got, want, dtype):
    """The flagged sets must be equal; in f64 the verdicts and the
    iterations too; in f32 the MAP/NONCONV split and the iterations
    (+-1) may differ on at most 0.5% of the flagged slots.  Returns the
    counts."""
    import torch

    flagged = int((want[5] != 0).sum())
    same_set = bool(torch.equal(got[5] != 0, want[5] != 0))
    verdicts = int((got[5] != want[5]).sum())
    iters = int(((got[6] - want[6]).abs() > (1 if dtype == torch.float32
                                              else 0)).sum())
    ok = same_set and (verdicts == iters == 0 if dtype == torch.float64
                       else verdicts + iters <= 0.005 * flagged)
    return {"flagged": flagged, "same_flagged_set": same_set,
            "verdicts_differ": verdicts, "iters_differ": iters,
            "nonconv": int((want[5] == 4).sum()), "ok": ok}


def phase_robust_kernels():
    """K12's and K9's robust instantiations against their plain versions
    on the card, each likelihood, f64 and f32 (normwise 1e-9 / 1e-3,
    NaN-strict; verdicts and iterations by :func:`_verdict_check`) on the
    flagship bucket (B = 512, (24, 32)) at k = 1 and k = 4, an armed mix;
    the bitwise contracts, kernel and plain alike (an armed censored
    update whose readings never rail, and a disarmed one of each
    likelihood, are K12 ``off`` or K9 from the given carry); a one-slot
    probe (each railed reading moves its slot's prediction only toward
    its rail); the Student-t solves at the default scale reported.  Then
    each mode timed at B = 512, k = 1 in f32 beside its bound."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import (
        gated_filter_append,
        gated_filter_append_plain,
        robust_filter_append,
        robust_filter_append_plain,
        sqrt_filter,
        sqrt_filter_plain,
        sqrt_filter_robust,
        sqrt_filter_robust_plain,
    )
    from metran_tpu_torch.ops import chol_outer
    from metran_tpu_torch.ops.kalman import _lanes_ss
    from metran_tpu_torch.ops.statespace import StateSpace

    dev = torch.device(DEVICE)
    checks, times, contracts, verdicts = [], {}, {}, {}

    def record(kernel, case, dtype, got, want, bar, vcheck):
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        checks.append({
            "kernel": kernel, "case": case, "dtype": str(dtype)[6:],
            "rel_err": errs, "bar": bar,
            "max_abs_err": max(abs_err(g, w) for g, w in zip(got, want)),
            "ok": within(errs, bar) and vcheck["ok"]})
        verdicts[f"{kernel} {case} {str(dtype)[6:]}"] = vcheck

    def lanes_of(args):
        phi, q, z, r = _lanes_ss(StateSpace(*args[:4]), "sqrt")
        return phi, q, z, r, args[6], args[7]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))

    for dtype in (torch.float64, torch.float32):
        bar = 1e-9 if dtype == torch.float64 else 1e-3
        tag = str(dtype)[6:]
        for lik in ROBUST_LIKELIHOODS:
            for k in (1, 4):
                rng = np.random.default_rng(SEED + 110 + k)
                args, armed, par, _ = _robust_case(rng, dtype, dev, lik, k)
                got = robust_filter_append(*args, armed, *par,
                                           likelihood=lik)
                want = robust_filter_append_plain(*args, armed, *par,
                                                  likelihood=lik)
                torch.cuda.synchronize()
                case = f"{lik}, B={FLEET} k={k} (24, 32)"
                record("gated_filter_robust", case, dtype, got[:5],
                       want[:5], bar, _verdict_check(got, want, dtype))
                require(bool(got[5].any()) and not got[5][3::4].any(),
                        f"K12 {lik}: nothing flagged, or a disarmed model "
                        "flagged")
                lanes = lanes_of(args)
                m0, c0 = args[4].contiguous(), _psd_factor(args[5])
                got = sqrt_filter_robust(*lanes, m0, c0, armed, *par,
                                         likelihood=lik)
                want = sqrt_filter_robust_plain(*lanes, m0, c0, armed,
                                                *par, likelihood=lik)
                torch.cuda.synchronize()
                record("sqrt_filter_robust", case, dtype,
                       (got[0], chol_outer(got[1]), *got[2:5]),
                       (want[0], chol_outer(want[1]), *want[2:5]), bar,
                       _verdict_check(got, want, dtype))
                require(bool(got[5].any()) and not got[5][3::4].any(),
                        f"K9 robust {lik}: nothing flagged, or a disarmed "
                        "model flagged")
            # the bitwise contracts, kernel and plain (k = 1)
            rng = np.random.default_rng(SEED + 111)
            args, armed, par, _ = _robust_case(rng, dtype, dev, lik)
            lo, hi, quantum, scale = par
            lanes = lanes_of(args)
            m0, c0 = args[4].contiguous(), _psd_factor(args[5])
            runs = {"disarmed": (torch.zeros_like(armed), par)}
            if lik == "censored":
                runs["never railed"] = (armed, (lo - 1e6, hi + 1e6, quantum,
                                                scale))
            for name, (arm, prm) in runs.items():
                for route, k12, k12_off, k9, k9_off in (
                        ("kernel", robust_filter_append, gated_filter_append,
                         sqrt_filter_robust, sqrt_filter),
                        ("plain", robust_filter_append_plain,
                         gated_filter_append_plain,
                         sqrt_filter_robust_plain, sqrt_filter_plain)):
                    out = k12(*args, arm, *prm, likelihood=lik)
                    off = k12_off(*args, armed, "off", 0.0)
                    ok12 = same(out, off) and not out[5].any()
                    out = k9(*lanes, m0, c0, arm, *prm, likelihood=lik)
                    torch.cuda.synchronize()
                    base = k9_off(*lanes, mean0=m0, chol0=c0)
                    torch.cuda.synchronize()
                    ok9 = same(out, base) and not out[5].any()
                    contracts[f"K12 {lik} {name} == off, {route}, {tag}"] = (
                        ok12)
                    contracts[f"K9 robust {lik} {name} == K9, {route}, "
                              f"{tag}"] = ok9
                    require(ok12 and ok9, f"{lik} {name} ({route}, {tag}) "
                            "is not the plain update bit for bit")
        # the one-slot probe: a reading at a rail moves its own slot's
        # prediction only toward the rail's side (the truth lies beyond
        # it), even where the reading sits on the other side of the
        # prediction and a Gaussian update would pull it back
        rng = np.random.default_rng(SEED + 112)
        args, armed, par, _ = _robust_case(rng, dtype, dev, "censored")
        phi, q, z, r, m0, cov0, y, mask = args
        pred = (z[:, 0] * (phi * m0)).sum(-1)  # slot 0's prior prediction
        hi_side = torch.arange(FLEET, device=dev) % 2 == 0
        y1 = torch.zeros_like(y)
        y1[:, 0, 0] = torch.where(hi_side, pred - 0.5, pred + 0.5)
        m1 = torch.zeros_like(mask)
        m1[:, 0, 0] = True
        lo1 = torch.where(hi_side, y1[:, 0, 0] - 10.0, y1[:, 0, 0])
        hi1 = torch.where(hi_side, y1[:, 0, 0], y1[:, 0, 0] + 10.0)
        prm = (lo1[:, None].expand_as(par[0]).contiguous(),
               hi1[:, None].expand_as(par[0]).contiguous(), *par[2:])
        lanes = (*lanes_of(args)[:4], y1, m1)
        c0 = _psd_factor(cov0)
        for kern, out in (
                ("K12", robust_filter_append(phi, q, z, r, m0, cov0, y1, m1,
                                             armed, *prm)),
                ("K9", sqrt_filter_robust(*lanes, m0, c0, armed, *prm))):
            moved = (z[:, 0] * out[0]).sum(-1) - pred
            up = torch.where(hi_side, moved, -moved)[armed]
            # the sums' roundoff: the slot's prediction is formed here and
            # in the kernel in different orders
            tol = (1e-12 if dtype == torch.float64 else 1e-5) * max(
                1.0, float(pred.abs().max()))
            ok = bool((up >= -tol).all()
                      and (out[5][armed, 0, 0] != 0).all())
            contracts[f"{kern} railed slot moves toward its rail, {tag}"] = ok
            require(ok, f"{kern}: a railed reading moved its slot away from "
                    "its rail's side")
        # Student-t at the default scale: the share of solves at the cap,
        # kernel against plain (reported, not held)
        rng = np.random.default_rng(SEED + 113)
        args, armed, par, _ = _robust_case(rng, dtype, dev, "huber_t",
                                           t_scale=ROBUST_SCALE)
        got = robust_filter_append(*args, armed, *par, likelihood="huber_t")
        want = robust_filter_append_plain(*args, armed, *par,
                                          likelihood="huber_t")
        torch.cuda.synchronize()
        flagged = int((want[5] != 0).sum())
        verdicts[f"huber_t at scale {ROBUST_SCALE}, K12, {tag}"] = {
            "flagged": flagged,
            "nonconv_share": float((want[5] == 4).sum()) / max(flagged, 1),
            "mean_iters": float(want[6][want[5] != 0].double().mean()),
            "rel_err_mean": rel_err(got[0], want[0])}
    for c in checks:
        emit({"phase": "kernel_check", **c})
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"kernel disagrees with its plain version: {bad}; "
            f"verdicts {verdicts}")

    # each mode at the main path's shape: B = 512, k = 1, f32
    dtype = torch.float32
    for lik in ROBUST_LIKELIHOODS:
        rng = np.random.default_rng(SEED + 114)
        args, armed, par, _ = _robust_case(rng, dtype, dev, lik)
        lanes = lanes_of(args)
        m0, c0 = args[4].contiguous(), _psd_factor(args[5])
        n, s = args[2].shape[1:]
        suffix = "" if lik == "censored" else f"_{lik}"
        for key, fn, plain, base_cost in (
                ("gated_filter_robust",
                 lambda: robust_filter_append(*args, armed, *par,
                                              likelihood=lik),
                 lambda: robust_filter_append_plain(*args, armed, *par,
                                                    likelihood=lik),
                 k12_cost(args[2], args[1], args[7], 4)),
                ("sqrt_filter_robust",
                 lambda: sqrt_filter_robust(*lanes, m0, c0, armed, *par,
                                            likelihood=lik),
                 lambda: sqrt_filter_robust_plain(*lanes, m0, c0, armed,
                                                  *par, likelihood=lik),
                 k9_gated_cost(lanes[2], lanes[5], torch.arange(
                     FLEET, dtype=torch.int32, device=dev), 4))):
            ms, out = cuda_ms(fn, reps=20)
            plain_ms, _ = cuda_ms(plain, reps=3, warm=1)
            bms, bby = bound_ms(*robust_cost(base_cost, out[5], out[6], lik,
                                             4), "float32")
            flag = out[5] != 0
            times[key + suffix] = {
                "shape": f"{lik}, B={FLEET} k=1 N={n} S={s} f32 (update "
                         "dispatch)",
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": bby, "flagged_slots": int(flag.sum()),
                "mean_iters": float(out[6][flag].double().mean())}
    torch.cuda.empty_cache()
    emit({"phase": "robust_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar",
                           "ok")} for c in checks],
        "verdicts": verdicts, "bitwise_contracts": contracts,
        "times": times})
    return checks, times


GATED_ROUNDS = 12  # update rounds of the gated serving path
GATED_CPU = 16  # models whose rounds are replayed in f64 on the CPU
SPIKE_DATA = 5.0  # spikes in data units (over 5 innovation sigmas)
SHIFT = (1, 3, 2, 4.0)  # model, slot, first round, size (data units)
POISONED, COLD = 2, 3  # a NaN posterior; t_seen below the gate's floor


def phase_gated_serving(engine, policy="reject", rounds=GATED_ROUNDS,
                        sync=True):
    """The serving path with its input defences, through the entry
    points a user calls: ``ModelRegistry(engine=engine)`` holding the
    flagship fleet's 512 posteriors after its 5,000-step history pass,
    and ``MetranService(registry, gate=GateSpec(policy=policy),
    detect=DetectSpec(enabled=True))`` assimilating ``rounds`` rows of
    the fleet's own continuation, with spikes on known (model, slot)
    cells, a level shift on one series, a poisoned model and a cold one.
    Checks: the armed spikes flagged, the cold model disarmed, the
    poisoned model's breaker open after ``breaker_failures`` failures
    while every other slot of the same launches committed, ``health()``
    naming it, the shift raising a changepoint in ``anomalies()`` and an
    ``alerts()`` entry, one update launch and one detector launch per
    dispatch, and the flagged counts of GATED_CPU models equal to a CPU
    f64 replay of the rounds through the plain versions (models with a
    score within 1e-3 of the gate are reported, not compared).  With
    ``sync``, 8 threads then make synchronous update/forecast calls
    through the background flusher.  Returns the launch counts and the
    timings."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.ops import (
        chol_outer,
        dfm_statespace,
        gated_filter_append,
        gated_sqrt_filter_append,
        kalman_filter,
        sqrt_kalman_filter,
    )
    from metran_tpu_torch.reliability import CircuitOpenError
    from metran_tpu_torch.serve import (
        DetectSpec,
        GateSpec,
        MetranService,
        ModelRegistry,
        PosteriorState,
    )

    dev = torch.device(DEVICE)
    f32 = np.float32
    sqrt = engine == "sqrt"
    gate = GateSpec(policy=policy)
    rng = np.random.default_rng(SEED + 100)
    y, mask, lds, a_s, a_c = make_workload(rng, FLEET, t=T_STEPS + rounds)
    y, mask = y.astype(f32), mask
    rows = np.where(mask[:, T_STEPS:], y[:, T_STEPS:], np.nan)
    spiked = {}
    for b in range(4, 4 + 32):
        # the first observed slot from b % N: the spike sits on a real
        # reading (a standardized series' predictive sd is below 1, so
        # the spike is over 5 sigmas)
        r = b % rounds
        i = next((b + j) % N_SERIES for j in range(N_SERIES)
                 if np.isfinite(rows[b, r, (b + j) % N_SERIES]))
        rows[b, r, i] += SPIKE_DATA
        spiked[b] = (r, i)
    rows[COLD, 0, 0] = SPIKE_DATA
    m_s, i_s, r_s, size = SHIFT
    rows[m_s, r_s:, i_s] = np.nan_to_num(rows[m_s, r_s:, i_s]) + size
    reset_launches()
    ss = dfm_statespace(a_s.astype(f32), a_c.astype(f32), lds.astype(f32),
                        1.0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    yh, mh = y[:, :T_STEPS], mask[:, :T_STEPS]
    if sqrt:
        res = sqrt_kalman_filter(ss, yh, mh, store=False)
        chols = res.chol_f.cpu().numpy()
        covs = chol_outer(res.chol_f).cpu().numpy()
    else:
        res = kalman_filter(ss, yh, mh, engine=engine, store=False)
        covs, chols = res.cov_f.cpu().numpy(), [None] * FLEET
    means = res.mean_f.cpu().numpy()
    t_history = time.perf_counter() - t0
    reg = ModelRegistry(root=None, engine=engine)
    names = tuple(f"s{j}" for j in range(N_SERIES))
    ids = [f"m{i}" for i in range(FLEET)]
    start = []
    for i in range(FLEET):
        st = PosteriorState(
            model_id=ids[i], version=0,
            t_seen=10 if i == COLD else T_STEPS,
            mean=(np.full_like(means[i], np.nan) if i == POISONED
                  else means[i]), cov=covs[i],
            params=np.concatenate([a_s[i], a_c[i]]).astype(f32),
            loadings=lds[i].astype(f32), dt=1.0,
            scaler_mean=np.zeros(N_SERIES, f32),
            scaler_std=np.ones(N_SERIES, f32), names=names, chol=chols[i])
        reg.put(st, persist=False)
        start.append(st)
    svc = MetranService(reg, flush_deadline=None, max_batch=1024,
                        persist_updates=False, gate=gate,
                        detect=DetectSpec(enabled=True), device=dev)
    upd_times, outcomes = [], []
    before = launches()
    for r in range(rounds):
        futs = {}
        for i, mid in enumerate(ids):
            try:
                futs[mid] = svc.update_async(mid, rows[i, r][None])
            except CircuitOpenError:
                futs[mid] = "CircuitOpenError"
        t = time.perf_counter()
        svc.flush()
        upd_times.append(time.perf_counter() - t)
        outcomes.append({mid: (f if isinstance(f, str) else (
            type(f.exception()).__name__ if f.exception() is not None
            else "ok")) for mid, f in futs.items()})
    after = launches()
    kern = "sqrt_filter_gated" if sqrt else "gated_filter"
    per_dispatch = {k: (after[k] - before[k]) / rounds for k in after
                    if after[k] != before[k]}
    require(per_dispatch == {kern: 1.0, "detect": 1.0},
            f"launches per update dispatch: {per_dispatch}")
    failures = svc.reliability.breaker_failures
    poisoned = [o[ids[POISONED]] for o in outcomes]
    require(poisoned[:failures] == ["StateIntegrityError"] * failures
            and set(poisoned[failures:]) == {"CircuitOpenError"},
            f"the poisoned model's outcomes: {poisoned}")
    for o in outcomes:
        bad = {m: v for m, v in o.items()
               if m != ids[POISONED] and v != "ok"}
        require(not bad, f"slots of a launch failed: {bad}")
    for i, mid in enumerate(ids):
        if i != POISONED:
            st = reg.get(mid)
            require(st.version == rounds and np.isfinite(st.mean).all(),
                    (mid, st.version))
    health = svc.health()
    require(health["breakers"]["open"] == [ids[POISONED]],
            f"health breakers: {health['breakers']}")
    gate_stats = svc.monitor.gate_stats()
    missed = [b for b in spiked if b % 4 != 3
              and gate_stats.get(ids[b], {}).get("rejected", 0) < 1]
    require(not missed, f"armed spikes not flagged: {missed}")
    require(gate_stats.get(ids[COLD], {}).get("rejected", 0) == 0,
            "the cold model was gated")
    anomalies = svc.anomalies()
    shift = anomalies[ids[m_s]]
    require(shift["cusum_alarms"] >= 1
            and f"s{i_s}" in shift["slots_flagged"],
            "the level shift raised no changepoint: "
            f"{ {k: shift[k] for k in ('cusum_alarms', 'slots_flagged')} }")
    alerts = {(a["model_id"], a["kind"]) for a in svc.alerts()}
    require((ids[m_s], "changepoint") in alerts, f"alerts: {alerts}")

    # the CPU f64 replay of GATED_CPU models' rounds (plain versions)
    picks = sorted({m_s, COLD, *range(4, 4 + GATED_CPU - 2)})[:GATED_CPU]
    near, compared, errs = [], 0, []
    for i in picks:
        st = start[i]
        ss_c = dfm_statespace(a_s[i].astype(f32).astype(float),
                              a_c[i].astype(f32).astype(float),
                              lds[i].astype(f32).astype(float), 1.0,
                              device="cpu")
        m = torch.as_tensor(st.mean, dtype=torch.float64)
        fac = torch.as_tensor(st.chol if sqrt else st.cov,
                              dtype=torch.float64)
        flagged, t_seen, close = 0, st.t_seen, False
        for r in range(rounds):
            row = rows[i, r]
            msk = np.isfinite(row)
            fn = gated_sqrt_filter_append if sqrt else gated_filter_append
            m, fac, _, _, z, v = fn(
                ss_c, m, fac, np.where(msk, row, 0.0)[None], msk[None],
                armed=t_seen >= gate.min_seen, policy=policy,
                nsigma=gate.nsigma, device="cpu")
            t_seen += 1
            flagged += int((v != 0).sum())
            score = z[torch.isfinite(z)] ** 2
            close |= bool(((score - gate.nsigma ** 2).abs()
                           < 1e-3 * gate.nsigma ** 2).any())
        got = gate_stats.get(ids[i], {}).get("rejected", 0)
        if close:
            near.append(ids[i])
            continue
        compared += 1
        require(got == flagged, f"{ids[i]}: card flagged {got}, CPU f64 "
                f"{flagged}")
        cov_c = chol_outer(fac) if sqrt else fac
        now = reg.get(ids[i])
        errs.append(max(rel_err(torch.as_tensor(now.mean), m),
                        rel_err(torch.as_tensor(now.cov), cov_c)))
    require(compared >= GATED_CPU - 2 and within(errs, 1e-3),
            f"CPU f64 replay: compared {compared}, errors {errs}")
    svc.close()

    call_ms: dict = {"update": [], "forecast": []}
    if sync:
        sync_ids = ids[64:128]
        sync_rows = np.random.default_rng(SEED + 101).normal(
            size=(64, 1, N_SERIES)) * 0.05
        errors: list = []
        lock = threading.Lock()
        with MetranService(reg, flush_deadline=0.002, max_batch=1024,
                           persist_updates=False, gate=gate,
                           detect=DetectSpec(enabled=True),
                           device=dev) as svc2:

            def worker(w):
                try:
                    for j in range(w, 64, 8):
                        t = time.perf_counter()
                        st = svc2.update(sync_ids[j], sync_rows[j])
                        t_u = time.perf_counter() - t
                        t = time.perf_counter()
                        f = svc2.forecast(ids[-64 + j], FORECAST_STEPS)
                        t_f = time.perf_counter() - t
                        require(st.version == rounds + 1,
                                (sync_ids[j], st.version))
                        require(np.isfinite(f.means).all(),
                                "non-finite forecast")
                        with lock:
                            call_ms["update"].append(t_u * 1e3)
                            call_ms["forecast"].append(t_f * 1e3)
                except BaseException as exc:  # noqa: BLE001 - re-raised
                    with lock:
                        errors.append(exc)

            threads = [threading.Thread(target=worker, args=(w,))
                       for w in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
                require(not th.is_alive(), "a sync-call thread hung")
        if errors:
            raise errors[0]
    counts = launches()
    for k in (kern, "detect"):
        require(counts[k] > 0, f"gated serving never launched {k}")

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p)) if xs else None

    out = {"update_dispatch_ms": pct(upd_times, 50) * 1e3,
           "update_dispatch_p99_ms": pct(upd_times, 99) * 1e3,
           "sync_update_p50_ms": pct(call_ms["update"], 50),
           "sync_update_p99_ms": pct(call_ms["update"], 99),
           "sync_forecast_p50_ms": pct(call_ms["forecast"], 50)}
    emit({"phase": "gated_serving", "engine": engine, "policy": policy,
          "fleet": FLEET, "rounds": rounds, "history_pass_s": t_history,
          **out, "launches_per_dispatch": per_dispatch,
          "gate_verdicts": health.get("gate_verdicts"),
          "degraded_models": health["gate"]["degraded_models"],
          "detect": health["detect"], "breakers": health["breakers"],
          "shift_model": shift, "cpu_f64": {
              "compared": compared, "near_threshold": near,
              "max_rel_err": max(errs) if errs else None},
          "launches": counts})
    return counts, out


ROBUST_ROUNDS = 12  # update rounds of the robust serving runs
ROBUST_CPU = 16  # models whose rounds are replayed in f64 on the CPU
ROBUST_COLD = 3  # a model with t_seen below the robust floor


def phase_robust_serving(engine, likelihood, rounds=ROBUST_ROUNDS,
                         sync=False, detect=False):
    """The robust serving path through the entry points a user calls:
    ``ModelRegistry(engine=engine)`` holding the flagship fleet's 512
    posteriors after its 5,000-step history pass, and
    ``MetranService(registry, robust=RobustSpec(likelihood=...))``
    assimilating ``rounds`` rows of the fleet's own continuation as the
    likelihood's sensor reports them (clipped at rails ROBUST_RAIL_Q of
    the readings reach, rounded to ROBUST_QUANTUM, or spiked by
    ROBUST_SPIKE_SD predictive sds on 32 known cells), one model cold
    (below ``min_seen``).  Checks: one robust launch per dispatch (and
    one K13 with ``detect``); every armed observation flagged where the
    likelihood says (the MAP slots counted against the data); every armed
    commit booked (a MAP update or a fallback) and the cold model never;
    ``health()`` showing the counters; ROBUST_CPU models replayed on the
    CPU through the plain versions: in f32 the same observations and
    non-converged solves per model and posteriors within 1e-3 of the
    card's, in f64 within 1e-2 (the f32 solve stops at 8 sqrt(eps) of
    its residual; the non-converged counts are reported); censored: a probe
    round of readings at a rail moves each read slot's prediction only
    toward the rail's side; huber_t: each replayed spike
    moves the state less than a third of what the plain update moves it.
    With ``sync``, 8 threads then make synchronous calls.  Returns the
    launch counts and the timings."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.ops import (
        chol_outer,
        dfm_statespace,
        implicit_map_filter_append,
        implicit_map_sqrt_filter_append,
        kalman_filter,
        sqrt_kalman_filter,
    )
    from metran_tpu_torch.serve import (
        DetectSpec,
        MetranService,
        ModelRegistry,
        PosteriorState,
        RobustSpec,
    )

    dev = torch.device(DEVICE)
    f32 = np.float32
    sqrt = engine == "sqrt"
    rng = np.random.default_rng(SEED + 120)
    y, mask, lds, a_s, a_c = make_workload(rng, FLEET, t=T_STEPS + rounds)
    y = y.astype(f32)
    rows = np.where(mask[:, T_STEPS:], y[:, T_STEPS:], np.nan)
    obs = rows[np.isfinite(rows)]
    kw = dict(likelihood=likelihood, scale=ROBUST_SCALE)
    if likelihood == "censored":
        # rails a float32 holds exactly, so the card's standardized rails
        # and the CPU replay's are the same numbers
        kw.update(rail_lo=float(f32(np.quantile(obs, ROBUST_RAIL_Q))),
                  rail_hi=float(f32(np.quantile(obs, 1.0 - ROBUST_RAIL_Q))))
        rows = np.clip(rows, kw["rail_lo"], kw["rail_hi"])
    elif likelihood == "quantized":
        kw.update(quantum=ROBUST_QUANTUM)
        rows = ROBUST_QUANTUM * np.round(rows / ROBUST_QUANTUM)
    else:
        kw.update(scale=ROBUST_T_SCALE)
    spec = RobustSpec(**kw)
    reset_launches()
    ss = dfm_statespace(a_s.astype(f32), a_c.astype(f32), lds.astype(f32),
                        1.0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    yh, mh = y[:, :T_STEPS], mask[:, :T_STEPS]
    if sqrt:
        res = sqrt_kalman_filter(ss, yh, mh, store=False)
        cov_t = chol_outer(res.chol_f)
        chols = res.chol_f.cpu().numpy()
    else:
        res = kalman_filter(ss, yh, mh, engine=engine, store=False)
        cov_t, chols = res.cov_f, [None] * FLEET
    means, covs = res.mean_f.cpu().numpy(), cov_t.cpu().numpy()
    t_history = time.perf_counter() - t0
    spiked = {}
    if likelihood == "huber_t":
        # ROBUST_SPIKE_SD one-step predictive sds on one observed slot of
        # 32 models, in their first round (the replay checks each)
        p_pred = (ss.phi[:, :, None] * cov_t * ss.phi[:, None, :] + ss.q)
        sd = torch.sqrt(torch.einsum("bis,bst,bit->bi", ss.z, p_pred, ss.z)
                        + ss.r).cpu().numpy()
        for b in range(4, 4 + 32):
            i = next((b + j) % N_SERIES for j in range(N_SERIES)
                     if np.isfinite(rows[b, 0, (b + j) % N_SERIES]))
            size = (1.0 if b % 2 else -1.0) * ROBUST_SPIKE_SD * sd[b, i]
            rows[b, 0, i] += size
            spiked[b] = (i, size)
    reg = ModelRegistry(root=None, engine=engine)
    names = tuple(f"s{j}" for j in range(N_SERIES))
    ids = [f"m{i}" for i in range(FLEET)]
    start = []
    for i in range(FLEET):
        st = PosteriorState(
            model_id=ids[i], version=0,
            t_seen=10 if i == ROBUST_COLD else T_STEPS,
            mean=means[i], cov=covs[i],
            params=np.concatenate([a_s[i], a_c[i]]).astype(f32),
            loadings=lds[i].astype(f32), dt=1.0,
            scaler_mean=np.zeros(N_SERIES, f32),
            scaler_std=np.ones(N_SERIES, f32), names=names, chol=chols[i])
        reg.put(st, persist=False)
        start.append(st)
    det = DetectSpec(enabled=True) if detect else None
    svc = MetranService(reg, flush_deadline=None, max_batch=1024,
                        persist_updates=False, robust=spec, detect=det,
                        device=dev)
    upd_times = []
    before = launches()
    for r in range(rounds):
        futs = {mid: svc.update_async(mid, rows[i, r][None])
                for i, mid in enumerate(ids)}
        t = time.perf_counter()
        svc.flush()
        upd_times.append(time.perf_counter() - t)
        bad = {m: type(f.exception()).__name__ for m, f in futs.items()
               if f.exception() is not None}
        require(not bad, f"robust updates failed: {bad}")
    after = launches()
    kern = "sqrt_filter_robust" if sqrt else "gated_filter_robust"
    per_dispatch = {k: (after[k] - before[k]) / rounds for k in after
                    if after[k] != before[k]}
    want_launches = {kern: 1.0, **({"detect": 1.0} if detect else {})}
    require(per_dispatch == want_launches,
            f"launches per update dispatch: {per_dispatch}")
    for mid in ids:
        require(reg.get(mid).version == rounds, mid)
    counts = svc.robust_total.snapshot()
    armed_obs = np.isfinite(rows).copy()
    armed_obs[ROBUST_COLD] = False
    if likelihood == "censored":
        flag = armed_obs & ((rows <= spec.rail_lo) | (rows >= spec.rail_hi))
    else:
        flag = armed_obs
    require(counts.get("map_slots", 0) == int(flag.sum()),
            f"MAP slots {counts.get('map_slots')} != the {int(flag.sum())} "
            "the data flag")
    require(counts.get("map_updates", 0) + counts.get("fallback_updates", 0)
            == rounds * (FLEET - 1),
            f"armed commits booked: {counts} (the cold model must book none)")
    health = svc.health()
    require(health["robust_total"] == counts and counts, health.get(
        "robust_total"))
    require(sum(health["robust_iterations"].values()) == counts["map_slots"],
            health["robust_iterations"])
    window = svc.monitor.gate_stats()

    # the CPU replay of ROBUST_CPU models through the plain versions, in
    # f32 (the card's arithmetic and solver tolerance) and in f64
    picks = sorted({ROBUST_COLD, *range(4, 4 + ROBUST_CPU - 1)})[:ROBUST_CPU]
    fn = (implicit_map_sqrt_filter_append if sqrt
          else implicit_map_filter_append)
    par = dict(rail_lo=spec.rail_lo, rail_hi=spec.rail_hi,
               quantum=spec.quantum if spec.quantum > 0 else 1.0,
               scale=spec.scale, likelihood=likelihood, nu=spec.nu)
    errs = {"float32": [], "float64": []}
    nonconv = {"card": 0, "float32": 0, "float64": 0}
    same_nonconv, influence = True, []
    for i in picks:
        st = start[i]
        got = window.get(ids[i], {"observed": 0, "rejected": 0})
        nonconv["card"] += got["rejected"]
        for dt in (torch.float32, torch.float64):
            tag = str(dt)[6:]
            ss_c = dfm_statespace(a_s[i].astype(f32), a_c[i].astype(f32),
                                  lds[i].astype(f32), 1.0, device="cpu",
                                  dtype=dt)
            m = torch.as_tensor(st.mean).to(dt)
            fac = torch.as_tensor(st.chol if sqrt else st.cov).to(dt)
            n_nonconv, n_obs, t_seen = 0, 0, st.t_seen
            for r in range(rounds):
                row = rows[i, r]
                msk = np.isfinite(row)
                armed = t_seen >= spec.min_seen
                y_r = np.where(msk, row, 0.0)[None]
                out = fn(ss_c, m, fac, y_r, msk[None], armed=armed,
                         device="cpu", **par)
                if r == 0 and i in spiked and dt == torch.float64:
                    # the spike's influence against the plain update's
                    slot, size = spiked[i]
                    clean = y_r.copy()
                    clean[0, slot] -= size
                    rc = fn(ss_c, m, fac, clean, msk[None], armed=armed,
                            device="cpu", **par)
                    g = dict(par, likelihood="gaussian")
                    ps = fn(ss_c, m, fac, y_r, msk[None], device="cpu", **g)
                    pc = fn(ss_c, m, fac, clean, msk[None], device="cpu",
                            **g)
                    influence.append(float((out[0] - rc[0]).abs().max()
                                           / (ps[0] - pc[0]).abs().max()))
                m, fac = out[0], out[1]
                t_seen += 1
                n_nonconv += int((out[5] == 4).sum())
                n_obs += int(msk.sum())
            nonconv[tag] += n_nonconv
            if dt == torch.float32:
                same_nonconv &= (got["observed"] == n_obs
                                 and got["rejected"] == n_nonconv)
            cov_c = chol_outer(fac) if sqrt else fac
            now = reg.get(ids[i])
            errs[tag].append(max(rel_err(torch.as_tensor(now.mean), m),
                                 rel_err(torch.as_tensor(now.cov), cov_c)))
    require(same_nonconv, "the card's observations or non-converged solves "
            "per model differ from the CPU f32 replay's")
    # f32 holds the card to the same arithmetic; f64 to the exact solve,
    # whose f32 twin stops at 8 sqrt(eps_f32) = 2.8e-3 of the
    # dimensionless residual (every flagged slot's MAP point carries up
    # to that much of its prior sd)
    require(within(errs["float32"], 1e-3) and within(errs["float64"], 1e-2),
            f"CPU replay: errors {errs}")
    if likelihood == "huber_t":
        require(influence and max(influence) < 1.0 / 3.0,
                f"spike influence against the plain update: {influence}")

    probe = None
    if likelihood == "censored":
        # a probe round: slot 0 of 16 armed models read at a rail; its
        # prediction may only move toward the rail's side
        probe_ids = list(range(40, 56))
        moved = []
        for j, i in enumerate(probe_ids):
            st = reg.get(ids[i])
            ss_i = dfm_statespace(a_s[i].astype(float),
                                  a_c[i].astype(float),
                                  lds[i].astype(float), 1.0, device="cpu")
            z0 = ss_i.z[0].numpy()
            pred = float(z0 @ (ss_i.phi.numpy() * st.mean))
            row = np.full(N_SERIES, np.nan)
            high = j % 2 == 0
            row[0] = spec.rail_hi if high else spec.rail_lo
            moved.append((high, pred, row[0]))
            svc.update_async(ids[i], row[None])
        svc.flush()
        ok = True
        for (high, pred, rail), i in zip(moved, probe_ids):
            st = reg.get(ids[i])
            ss_i = dfm_statespace(a_s[i].astype(float), a_c[i].astype(float),
                                  lds[i].astype(float), 1.0, device="cpu")
            after_pred = float(ss_i.z[0].numpy() @ st.mean)
            step = after_pred - pred if high else pred - after_pred
            ok &= step >= -1e-5 * max(1.0, abs(pred))
        probe = {"models": len(probe_ids), "toward_rail": ok}
        require(ok, "a railed reading moved its slot away from its rail")
    svc.close()

    call_ms: list = []
    if sync:
        sync_ids = ids[64:128]
        errors: list = []
        lock = threading.Lock()
        with MetranService(reg, flush_deadline=0.002, max_batch=1024,
                           persist_updates=False, robust=spec, detect=det,
                           device=dev) as svc2:

            def worker(w):
                try:
                    for j in range(w, len(sync_ids), 8):
                        i = 64 + j
                        t = time.perf_counter()
                        st = svc2.update(sync_ids[j], rows[i, -1][None])
                        t_u = time.perf_counter() - t
                        require(np.isfinite(st.mean).all(), sync_ids[j])
                        with lock:
                            call_ms.append(t_u * 1e3)
                except BaseException as exc:  # noqa: BLE001 - re-raised
                    with lock:
                        errors.append(exc)

            threads = [threading.Thread(target=worker, args=(w,))
                       for w in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
                require(not th.is_alive(), "a sync-call thread hung")
        if errors:
            raise errors[0]
    counts_all = launches()
    require(counts_all[kern] > 0, f"robust serving never launched {kern}")

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p)) if xs else None

    out = {"update_dispatch_ms": pct(upd_times, 50) * 1e3,
           "update_dispatch_p99_ms": pct(upd_times, 99) * 1e3,
           "sync_update_p50_ms": pct(call_ms, 50),
           "sync_update_p99_ms": pct(call_ms, 99)}
    emit({"phase": "robust_serving", "engine": engine,
          "likelihood": likelihood, "spec": spec._asdict(), "fleet": FLEET,
          "rounds": rounds, "history_pass_s": t_history, **out,
          "launches_per_dispatch": per_dispatch, "robust_total": counts,
          "robust_iterations": health["robust_iterations"],
          "degraded_models": health["gate"]["degraded_models"],
          "detect": health.get("detect"), "probe": probe,
          "spike_influence_max": max(influence) if influence else None,
          "cpu_replay": {"compared": len(picks), "nonconv": nonconv,
                         "max_rel_err": {k: max(v) for k, v in
                                         errs.items()}},
          "launches": counts_all})
    return counts_all, out


def phase_c2_defaults(mt):
    """The JAX defaults the port now shares, driven on the f64 example
    model ``mt`` on the card: ``innovations`` (the joint store, K1
    ``store``) held to the sequential engine's (K6 ``store``) within
    1e-9, ``sample_states`` (K7 draws, K1 ``store`` + K8 per chunk) held
    to the sequential engine's draws through the same normals within
    1e-9, and ``filter_append`` (K12 ``off``) over the last 100 rows from
    the joint store's carry, held to the store's last step within
    1e-9."""
    import torch

    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.ops import (
        filter_append,
        innovations,
        kalman_filter,
        sample_states,
    )
    from metran_tpu_torch.ops.kalman import (
        _draw_normals,
        _sample_states_given,
    )

    kf = mt.kf
    ss, y, mask = kf.ss, kf.y, kf.mask
    reset_launches()
    t0 = time.perf_counter()
    v_j, f_j = innovations(ss, y, mask)
    draws = sample_states(ss, y, mask, SEED, n_draws=8)
    filt = kalman_filter(ss, y, mask, engine="joint", store=True)
    tail = 100
    app = filter_append(ss, filt.mean_f[-tail - 1], filt.cov_f[-tail - 1],
                        y[-tail:], mask[-tail:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    v_s, f_s = innovations(ss, y, mask, engine="sequential")
    # the same normals (sample_states' generator, seed and order)
    normals = _draw_normals(8, y.shape[0], ss.phi.shape[0], y.shape[1],
                            torch.Generator(y.device).manual_seed(SEED),
                            y.dtype, y.device)
    seq = _sample_states_given(ss, y, mask, *normals, engine="sequential")
    errs = {"innovations": rel_err(v_j, v_s),
            "innovation_variances": rel_err(f_j, f_s),
            "sample_states": rel_err(draws, seq),
            "filter_append_mean": rel_err(app[0], filt.mean_f[-1]),
            "filter_append_cov": rel_err(app[1], filt.cov_f[-1])}
    require(within(list(errs.values()), 1e-9), f"C2 defaults: {errs}")
    for k in ("joint_filter_store", "gated_filter", "lanes_sample",
              "rts_smooth"):
        require(counts[k] > 0, f"C2 defaults never launched {k}")
    emit({"phase": "c2_defaults", "wall_s": wall, "rel_err": errs,
          "launches": counts})
    return counts


DEV_RTOL = 2e-6
PREC_ALPHAS = {
    "init": [10.0] * (PREC_N + PREC_K),
    "fast": [0.1] * (PREC_N + PREC_K),
    "near_unit_root": [3e4] * (PREC_N + PREC_K),
    "mixed": None,  # np.linspace(0.1, 100, N) and 1e4, built below
}


def make_precision_panel():
    """tests/test_precision.py::make_flagship: 20 series, 1 factor,
    5,000 steps, 30% missing, seed 0."""
    import numpy as np

    n, k, t = PREC_N, PREC_K, PREC_T
    rng = np.random.default_rng(0)
    loadings = rng.uniform(0.4, 0.8, (n, k))
    mask = rng.uniform(size=(t, n)) > 0.3
    mask[0] = False
    phi_c = np.exp(-1.0 / 30.0)
    phi_s = np.exp(-1.0 / rng.uniform(5, 40, n))
    common = np.zeros((t, k))
    specific = np.zeros((t, n))
    e_c = rng.normal(size=(t, k)) * np.sqrt(1 - phi_c**2)
    e_s = rng.normal(size=(t, n)) * np.sqrt(1 - phi_s**2)
    for i in range(1, t):
        common[i] = phi_c * common[i - 1] + e_c[i]
        specific[i] = phi_s * specific[i - 1] + e_s[i]
    comm = np.sum(loadings**2, axis=1)
    y = np.where(mask, specific * np.sqrt(1 - comm) + common @ loadings.T,
                 0.0)
    return y, mask, loadings


def phase_sqrt_precision():
    """The square-root engine's f32 contract on the card
    (tests/test_precision.py, the uncapped bar in every regime): in the
    four alpha regimes of the flagship precision panel, K9's f32
    deviance within DEV_RTOL = 2e-6 of the CPU f64 plain version's; the
    f32 factors of K9 ``store`` and K10 finite, and the final posterior
    passing ``posterior_fault(psd_tol=0, chol=...)``.  K3's f32
    (covariance-form) error in the same regimes is printed beside it,
    without a bar."""
    import numpy as np
    import torch

    from metran_tpu_torch.ops import (
        chol_outer,
        deviance,
        dfm_statespace,
        sqrt_kalman_filter,
        sqrt_rts_smoother,
    )
    from metran_tpu_torch.serve.engine import posterior_fault

    y, mask, loadings = make_precision_panel()
    n = PREC_N
    alphas = dict(PREC_ALPHAS)
    alphas["mixed"] = list(np.linspace(0.1, 100.0, n)) + [1e4]
    names = list(alphas)
    a = np.array([alphas[k] for k in names])
    b = len(names)
    ld = np.broadcast_to(loadings, (b, n, PREC_K))
    yb = np.broadcast_to(y, (b,) + y.shape)
    mb = np.broadcast_to(mask, yb.shape)
    t0 = time.perf_counter()
    ss64 = dfm_statespace(a[:, :n], a[:, n:], ld, 1.0, device="cpu")
    ref = deviance(ss64, yb, mb, engine="sqrt", device="cpu").numpy()
    cpu_s = time.perf_counter() - t0
    dev = torch.device(DEVICE)
    ss32 = dfm_statespace(a[:, :n].astype(np.float32),
                          a[:, n:].astype(np.float32),
                          ld.astype(np.float32), 1.0, device=dev)
    y32 = yb.astype(np.float32)
    sqrt32 = deviance(ss32, y32, mb, engine="sqrt").double().cpu().numpy()
    seq32 = deviance(ss32, y32, mb, engine="sequential").double().cpu(
    ).numpy()
    filt = sqrt_kalman_filter(ss32, y32, mb, store=True)
    sm = sqrt_rts_smoother(ss32, filt)
    torch.cuda.synchronize()
    out = {}
    for i, name in enumerate(names):
        finite = all(bool(torch.isfinite(f[i]).all()) for f in
                     (filt.chol_p, filt.chol_f, sm.chol_s))
        chol = filt.chol_f[i, -1].double().cpu().numpy()
        fault = posterior_fault(filt.mean_f[i, -1].double().cpu().numpy(),
                                chol_outer(filt.chol_f[i, -1]).double()
                                .cpu().numpy(), psd_tol=0.0, chol=chol)
        out[name] = {
            "deviance_f64_cpu": float(ref[i]),
            "sqrt_f32_rel_err": float(abs(sqrt32[i] - ref[i])
                                      / abs(ref[i])),
            "k3_f32_rel_err": float(abs(seq32[i] - ref[i]) / abs(ref[i])),
            "factors_finite": finite, "posterior_fault": fault}
    emit({"phase": "sqrt_precision", "t_steps": PREC_T, "bar": DEV_RTOL,
          "regimes": out, "cpu_f64_s": cpu_s})
    for name, o in out.items():
        require(o["sqrt_f32_rel_err"] <= DEV_RTOL,
                f"{name}: K9 f32 deviance vs CPU f64 {o}")
        require(o["factors_finite"], f"{name}: non-finite f32 factor")
        require(o["posterior_fault"] is None, f"{name}: {o}")

#: the kernel launchers a run times with CUDA events: (module, name)
TIMED_KERNELS = (
    ("metran_tpu_torch.kernels.joint_filter", "joint_filter_append_kernel"),
    ("metran_tpu_torch.kernels.joint_adjoint", "joint_adjoint_kernel"),
    ("metran_tpu_torch.kernels.lanes", "lanes_filter_kernel"),
    ("metran_tpu_torch.kernels.lanes", "lanes_adjoint_kernel"),
    ("metran_tpu_torch.kernels.lanes_products", "lanes_smooth_bwd_kernel"),
    ("metran_tpu_torch.kernels.lanes_products", "lanes_forward_kernel"),
    ("metran_tpu_torch.kernels.lanes_products", "lanes_sample_kernel"),
    ("metran_tpu_torch.kernels.forecast", "forecast_moments_kernel"),
    ("metran_tpu_torch.kernels.smoother", "rts_smooth_kernel"),
    ("metran_tpu_torch.kernels.sqrt_filter", "sqrt_filter_kernel"),
    ("metran_tpu_torch.kernels.sqrt_smoother", "sqrt_smooth_kernel"),
    ("metran_tpu_torch.kernels.joint_filter", "joint_filter_store_kernel"),
    ("metran_tpu_torch.kernels.pkalman", "parallel_filter_kernel"),
    ("metran_tpu_torch.kernels.pkalman", "parallel_smooth_kernel"),
    ("metran_tpu_torch.kernels.pkalman", "sqrt_parallel_filter_kernel"),
    ("metran_tpu_torch.kernels.pkalman", "sqrt_parallel_smooth_kernel"),
)


class _KernelTimer:
    """CUDA events around every launch of the kernels in
    :data:`TIMED_KERNELS` in a window (the device-busy share of a fit and
    of each product, and each kernel's share) and, for the lanes fit,
    host-clock times of each optimizer dispatch (its working-set
    width)."""

    def __init__(self):
        self.events = []
        self.dispatches = []

    def __enter__(self):
        import importlib

        import torch

        from metran_tpu_torch.parallel import lanes_lbfgs

        self._saved = [(importlib.import_module(mod), name)
                       for mod, name in TIMED_KERNELS]
        self._saved = [(mod, name, getattr(mod, name))
                       for mod, name in self._saved]
        self._runner = lanes_lbfgs.make_chunk_runner

        def timed(fn, name):
            def wrapper(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                self.events.append((start, end, name))
                return out
            return wrapper

        def make_timed_runner(*args, **kw):
            run = self._runner(*args, **kw)
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

        for mod, name, fn in self._saved:
            setattr(mod, name, timed(fn, name))
        lanes_lbfgs.make_chunk_runner = make_timed_runner
        return self

    def __exit__(self, *exc):
        from metran_tpu_torch.parallel import lanes_lbfgs

        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        lanes_lbfgs.make_chunk_runner = self._runner

    def kernel_ms(self, since=0, names=None):
        """Milliseconds of the launches timed since event ``since`` (of
        the launchers in ``names`` only, when given)."""
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e, name in self.events[since:]
                   if names is None or name in names)


def cpu_stderr(host, params):
    """The lanes-fd standard errors of the models in ``host`` (``y``,
    ``mask``, ``lds``) at ``params``, recomputed in f64 on the CPU with
    the plain versions.  Runs in a worker process; returns numpy
    ``(stderr, pcov)``."""
    import numpy as np

    sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(1)
    from metran_tpu_torch.data import Panel
    from metran_tpu_torch.parallel import fleet as pf

    names = [f"s{j}" for j in range(N_SERIES)]
    panels = [Panel(y, m, None, names, np.ones(N_SERIES),
                    np.zeros(N_SERIES), 1.0)
              for y, m in zip(host["y"], host["mask"])]
    fleet = pf.pack_fleet(panels, list(host["lds"]), dtype=torch.float64,
                          device="cpu")
    stderr, pcov = pf.fleet_stderr(params, fleet, method="lanes-fd",
                                   remat_seg=FIT["remat_seg"])
    return stderr.numpy(), pcov.numpy()


def phase_fit_path(pool):
    """The port's fleet fit at full width on the card, then the lanes-fd
    standard errors of the fitted fleet (B * 2P lanes over one copy of
    the data); CPU_MODELS models' standard errors are recomputed in f64
    in a worker process of ``pool`` (checked by :func:`check_stderr`
    once phases 6 and 7 have run)."""
    import numpy as np
    import torch

    from metran_tpu_torch.data import Panel
    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.parallel import (
        autocorr_init_params,
        fit_fleet,
        fleet_deviance,
        fleet_stderr,
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

    # the standard errors: 2P central-difference lanes per model reading
    # the model's one copy of the data through the lane map; the CPU
    # recompute runs as two jobs of half the models each (the plain
    # adjoint's Python loop costs the same for any number of lanes)
    idx_se = list(range(0, FLEET, FLEET // CPU_MODELS))
    se_futures = [
        pool.submit(cpu_stderr, {"y": y32[part].astype(np.float64),
                                 "mask": mask[part], "lds": lds[part]},
                    params[part].astype(np.float64))
        for part in (idx_se[::2], idx_se[1::2])]
    fit_counts = counts
    with _KernelTimer() as se_timer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stderr, _ = fleet_stderr(fit.params, fleet, method="lanes-fd",
                                 remat_seg=FIT["remat_seg"])
        torch.cuda.synchronize()
        se_wall = time.perf_counter() - t0
        se_kernel_ms = se_timer.kernel_ms()
    counts = launches()
    se = stderr.cpu().numpy()
    require(se.shape == params.shape, f"stderr shape {se.shape}")
    se_stats = {
        "lanes": FLEET * 2 * params.shape[1], "data_lanes": FLEET,
        "wall_s": se_wall, "kernel_ms": se_kernel_ms,
        "kernel_busy_share": se_kernel_ms / 1e3 / se_wall,
        "launches": {k: counts[k] - fit_counts[k] for k in counts
                     if counts[k] > fit_counts[k]},
        "nan_stderr": int(np.isnan(se).sum()),
        "models_with_nan": int(np.isnan(se).any(axis=1).sum()),
        "nan_at_interior_alpha": int(np.isnan(se[params < 1e3]).sum()),
    }

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
        "stderr": se_stats,
    })
    return {"counts": counts, "fleet": fleet, "params": fit.params,
            "p0": p0, "fit": fit, "wall": wall,
            "deviance": dev_fit, "dev_start": dev_start.cpu().numpy(),
            "converged_frac": float(fit.converged.float().mean()),
            "y32": y32, "mask": mask, "lds": lds,
            "stderr": (se_futures, se[idx_se[::2] + idx_se[1::2]],
                       params[idx_se[::2] + idx_se[1::2]],
                       idx_se[::2] + idx_se[1::2])}


# the batch-layout fit (phase 5b): fit_fleet with the JAX defaults
# (layout="batch", engine="joint") under the JAX bench's fit tolerances
BATCH_FIT = dict(maxiter=60, tol=0.05, stall_tol=1e-3)
BATCH_CPU = 8  # models whose value and gradient are recomputed in f64
#               (over the first ADJ_T_CMP steps)
SQRT_FIT_MODELS = 16  # the square-root engine's batch fit (K9 + K11)
SQRT_FIT = dict(maxiter=20, tol=0.05, stall_tol=1e-3)
# per-model |deviance gap| to the lanes fit, relative: the joint and
# sequential deviances are equal in exact arithmetic, and the f32 stall
# stops leave gaps of ~1e-5 (PERF.md); a fit at a wrong optimum, e.g.
# through a wrong gradient past the compared steps, leaves more
GAP_BAR = 1e-4


def cpu_batch_vg(host, params):
    """``fleet_value_and_grad(layout="batch")`` of the models in ``host``
    (``y``, ``mask``, ``lds``) at ``params``, in f64 on the CPU with the
    plain versions (K1 with boundaries, K11).  Runs in a worker process;
    returns numpy ``(values, grads)``."""
    import numpy as np

    sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(1)
    from metran_tpu_torch.parallel import fleet as pf

    b = len(host["y"])
    fleet = pf.Fleet(torch.as_tensor(host["y"]), torch.as_tensor(host["mask"]),
                     torch.as_tensor(host["lds"]), torch.ones(b),
                     torch.full((b,), N_SERIES))
    val, grad = pf.fleet_value_and_grad(np.asarray(params), fleet,
                                        device="cpu")
    return val.numpy(), grad.numpy()


class _RowCounter:
    """Counts the model rows the batch-layout objective evaluates (the
    line-search evaluations of every lane) by wrapping
    ``parallel.fleet._model_deviance``."""

    def __enter__(self):
        from metran_tpu_torch.parallel import fleet as pf

        self.rows = 0
        self.calls = 0
        self._saved = pf._model_deviance

        def counted(p, *args, **kw):
            self.rows += int(p.shape[0])
            self.calls += 1
            return self._saved(p, *args, **kw)

        pf._model_deviance = counted
        return self

    def __exit__(self, *exc):
        from metran_tpu_torch.parallel import fleet as pf

        pf._model_deviance = self._saved


def phase_batch_fit(pool, lanes):
    """The slice's path at full width: ``fit_fleet(fleet, p0=...)`` with
    the JAX defaults (``layout="batch"``, ``engine="joint"``, ``grad``
    auto -> the closed-form adjoint: K1 ``bounds`` forward, K11 backward,
    optax's zoom-line-search L-BFGS) on phase 5's flagship fleet, f32,
    held to phase 5's lane-layout fit of the same fleet; BATCH_CPU
    models' value and gradient at the fitted parameters recomputed in
    f64 on the CPU over the first ADJ_T_CMP steps; then the square-root
    engine's batch fit (K9 ``bounds`` + K11) on SQRT_FIT_MODELS of the
    models; then ``JaxSolve``'s fit in f64 (``METRAN_TPU_X64=1``) on the
    reference's example model on its card default ``engine="sqrt"`` (K9
    ``bounds`` + K11), held to the golden fit (its standard errors need
    the exact Hessian, ROADMAP A3, and are not run).  The launch counters
    are reset before and read after the three."""
    import json
    import os

    import numpy as np
    import torch

    from metran_tpu_torch import Metran
    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.models import JaxSolve
    from metran_tpu_torch.parallel import (
        Fleet,
        autocorr_init_params,
        fit_fleet,
        fleet_deviance,
        fleet_value_and_grad,
    )
    from metran_tpu_torch.parallel.fleet import (
        ALPHA_MAX,
        _alpha_to_theta,
        _theta_to_alpha,
    )

    fleet = lanes["fleet"]
    p0 = autocorr_init_params(fleet)
    cap = float(np.log(ALPHA_MAX))
    dev_start = fleet_deviance(_theta_to_alpha(_alpha_to_theta(p0, cap), cap),
                               fleet).cpu().numpy()
    reset_launches()
    with _KernelTimer() as timer, _RowCounter() as rows:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = fit_fleet(fleet, p0=p0, **BATCH_FIT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fit_counts = launches()
        k1_ms = timer.kernel_ms(names={"joint_filter_append_kernel"})
        k11_ms = timer.kernel_ms(names={"joint_adjoint_kernel"})
        all_ms = timer.kernel_ms()
    for kern in ("joint_filter_append", "joint_adjoint"):
        require(fit_counts[kern] > 0, f"batch fit never launched {kern}")
    iters = fit.iterations.cpu().numpy()
    dev_fit = fit.deviance.cpu().numpy()
    params = fit.params.cpu().numpy()
    require(np.isfinite(dev_fit).all() and np.isfinite(params).all(),
            "a batch-fit lane ended non-finite")
    worse = np.flatnonzero(dev_fit > dev_start)
    require(worse.size == 0, f"batch lanes ended worse: {worse}")
    conv = float(fit.converged.float().mean())
    require(conv >= lanes["converged_frac"],
            f"batch fit converged {conv} < the lanes fit's "
            f"{lanes['converged_frac']}")
    # the two layouts' optima (equal in exact arithmetic; the f32 stall
    # stops leave the gap)
    gap = (dev_fit - lanes["deviance"]) / np.abs(lanes["deviance"])
    require(np.abs(gap).max() <= GAP_BAR,
            f"batch fit deviances vs the lanes fit's: max |rel gap| "
            f"{np.abs(gap).max()} at model {int(np.abs(gap).argmax())}")

    # BATCH_CPU models: the card's f32 value and gradient at the fitted
    # parameters against the CPU f64 plain path, first ADJ_T_CMP steps
    idx = list(range(0, FLEET, FLEET // BATCH_CPU))
    y32, mask, lds = lanes["y32"], lanes["mask"], lanes["lds"]
    host = {"y": y32[idx, :ADJ_T_CMP].astype(np.float64),
            "mask": mask[idx, :ADJ_T_CMP], "lds": lds[idx]}
    future = pool.submit(cpu_batch_vg, host, params[idx].astype(np.float64))
    dev = fleet.y.device
    short = Fleet(fleet.y[idx, :ADJ_T_CMP].contiguous(),
                  fleet.mask[idx, :ADJ_T_CMP].contiguous(),
                  fleet.loadings[idx], fleet.dt[idx], fleet.n_series[idx])
    val32, grad32 = fleet_value_and_grad(fit.params[idx], short)

    # the square-root engine's batch fit (K9 bounds + K11), f32
    sel = torch.arange(SQRT_FIT_MODELS, device=dev)
    small = Fleet(*(None if a is None else a.index_select(0, sel)
                    for a in fleet))
    c0 = launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_s = fit_fleet(small, p0=p0[:SQRT_FIT_MODELS], engine="sqrt",
                      grad_engine="adjoint", **SQRT_FIT)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    c1 = launches()
    for kern in ("sqrt_filter", "joint_adjoint"):
        require(c1[kern] > c0[kern], f"sqrt batch fit never launched {kern}")
    dev_s = fit_s.deviance.cpu().numpy()
    require(np.isfinite(dev_s).all()
            and (dev_s <= dev_start[:SQRT_FIT_MODELS]).all(),
            f"sqrt batch fit: {dev_s}")
    gap_s = np.abs(dev_s - lanes["deviance"][:SQRT_FIT_MODELS]) \
        / np.abs(lanes["deviance"][:SQRT_FIT_MODELS])
    require(gap_s.max() <= GAP_BAR,
            f"sqrt batch fit deviances vs the lanes fit's: {gap_s}")

    # JaxSolve's fit core in f64 on the example, card default engine sqrt
    golden = json.loads(GOLDEN.read_text())
    os.environ["METRAN_TPU_X64"] = "1"
    try:
        mt = Metran(example_series(), name=EXAMPLE)
    finally:
        del os.environ["METRAN_TPU_X64"]
    require(mt.dtype == torch.float64 and mt._engine == "sqrt"
            and mt.device.type == "cuda", (mt.dtype, mt._engine))
    mt.get_factors(mt.oseries)
    mt._init_kalmanfilter()
    mt.set_init_parameters()
    solver = JaxSolve(mt=mt)
    c2 = launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, obj, nfev, converged = solver.fit_core()
    torch.cuda.synchronize()
    wall_j = time.perf_counter() - t0
    c3 = launches()
    for kern in ("sqrt_filter", "joint_adjoint"):
        require(c3[kern] > c2[kern], f"JaxSolve never launched {kern}")
    require(mt._resolved_grad() == "adjoint", mt._resolved_grad())
    opt = solver._full_params(x)
    obj_rel = abs(obj - golden["obj_func"]) / abs(golden["obj_func"])
    require(abs(obj - golden["obj_func"])
            <= max(1e-6 * abs(golden["obj_func"]), 1e-4),
            f"JaxSolve obj {obj} vs golden {golden['obj_func']}")
    opt_rel = float(np.max(np.abs(opt - golden["optimal"])
                           / np.abs(golden["optimal"])))
    require(opt_rel <= 2e-2, f"JaxSolve optimal {opt}")
    # the path's launches: the three fits', not the 8-model check's
    counts = {k: fit_counts[k] + c1[k] - c0[k] + c3[k] - c2[k]
              for k in fit_counts}

    val64, grad64 = future.result()
    v_rel = np.abs(val32.cpu().numpy() - val64) / np.abs(val64)
    g_rel = rel_err(grad32.cpu(), torch.as_tensor(grad64))
    require(within(v_rel.tolist(), 1e-4), f"batch value f32 vs f64 {v_rel}")
    require(g_rel <= 1e-3, f"batch gradient f32 vs f64 {g_rel}")
    emit({
        "phase": "batch_fit", "fleet": FLEET, "t_steps": T_STEPS,
        "settings": {**BATCH_FIT, "layout": "batch", "engine": "joint",
                     "grad": "adjoint"},
        "fit_wall_s": wall, "fits_per_s": FLEET / wall,
        "iterations": {"mean": float(iters.mean()), "max": int(iters.max())},
        "converged_frac": conv,
        "stalled_frac": float(fit.stalled.float().mean()),
        "objective_calls": rows.calls,
        "evaluations_per_model": rows.rows / FLEET,
        "kernel_ms": {"joint_filter_append_bounds": k1_ms,
                      "joint_adjoint": k11_ms, "all": all_ms},
        "kernel_share": {"joint_filter_append_bounds": k1_ms / 1e3 / wall,
                         "joint_adjoint": k11_ms / 1e3 / wall},
        "launches": {k: v for k, v in fit_counts.items() if v},
        "deviance_mean": float(dev_fit.mean()),
        "vs_lanes_fit": {
            "lanes_converged_frac": lanes["converged_frac"],
            "rel_gap_median": float(np.median(gap)),
            "rel_gap_min": float(gap.min()), "rel_gap_max": float(gap.max()),
            "bar": GAP_BAR,
            "batch_lower_frac": float((gap < 0).mean())},
        "cpu_f64_over_t": ADJ_T_CMP, "value_rel_err": float(v_rel.max()),
        "grad_rel_err": g_rel,
        "sqrt_fit": {"models": SQRT_FIT_MODELS, "settings": SQRT_FIT,
                     "wall_s": wall_s,
                     "iterations_mean": float(
                         fit_s.iterations.float().mean()),
                     "converged_frac": float(fit_s.converged.float().mean()),
                     "rel_gap_to_lanes_max": float(gap_s.max()),
                     "launches": {k: c1[k] - c0[k] for k in c1
                                  if c1[k] > c0[k]}},
        "jaxsolve_f64_example": {"engine": mt._engine, "wall_s": wall_j,
                                 "obj_func": obj, "obj_rel_to_golden": obj_rel,
                                 "optimal_rel_to_golden": opt_rel,
                                 "nfev": nfev, "converged": converged,
                                 "iterations": solver.telemetry.n_iters,
                                 "stop": solver.telemetry.stop_reason,
                                 "launches": {k: c3[k] - c2[k] for k in c3
                                              if c3[k] > c2[k]}},
    })
    return counts


def check_stderr(fit):
    """The card's f32 lanes-fd standard errors of CPU_MODELS fitted
    models against the CPU f64 recompute: at the parameters inside the
    box (alpha < 1e3; at the soft cap the curvature is ~0 and its sign
    is noise) NaN where the recompute is NaN and within 5e-2 relative
    elsewhere (the JAX package's own f32 lanes-fd bar,
    ``tests/test_parallel.py::test_fleet_stderr_lanes_fd_f32``: f32
    gradient noise through a cbrt(eps_f32) = 4.9e-3 step)."""
    import numpy as np

    futures, se_card, params, idx = fit["stderr"]
    t0 = time.perf_counter()
    se_cpu = np.concatenate([f.result()[0] for f in futures])
    wait_s = time.perf_counter() - t0
    interior = params < 1e3
    card, cpu = se_card[interior], se_cpu[interior]
    both = np.isfinite(card) & np.isfinite(cpu)
    rel = np.abs(card[both] - cpu[both]) / np.abs(cpu[both])
    nan_match = bool(np.array_equal(np.isnan(card), np.isnan(cpu)))
    emit({"phase": "fit_stderr_check", "models": idx,
          "interior_params": int(interior.sum()),
          "nan_pattern_matches": nan_match,
          "rel_err_max": float(rel.max()) if rel.size else 0.0,
          "rel_err_median": float(np.median(rel)) if rel.size else 0.0,
          "nan_card": int(np.isnan(se_card).sum()),
          "nan_cpu": int(np.isnan(se_cpu).sum()), "waited_s": wait_s})
    require(nan_match, "card vs CPU stderr: NaN pattern differs inside "
            "the box")
    require(within(rel.tolist(), 5e-2), f"card f32 vs CPU f64 stderr: {rel}")


PRODUCT_NAMES = ("simulate", "simulate_filtered", "decompose",
                 "innovations", "forecast", "sample")


def cpu_product(name, host, params, normals):
    """One product of the models in ``host`` (``y``, ``mask``, ``lds``)
    at ``params``, recomputed in f64 on the CPU with the plain versions;
    ``normals`` are the card's ``(x0, w, e)`` of the sample's models
    (model-major).  Runs in a worker process; returns numpy arrays."""
    import numpy as np

    sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(1)
    from metran_tpu_torch.data import Panel
    from metran_tpu_torch.ops.lanes import lanes_statespace
    from metran_tpu_torch.ops.lanes_products import (
        _lanes_sample_given,
        draw_major,
    )
    from metran_tpu_torch.parallel import fleet as pf

    names = [f"s{j}" for j in range(N_SERIES)]
    panels = [Panel(y, m, None, names, np.ones(N_SERIES),
                    np.zeros(N_SERIES), 1.0)
              for y, m in zip(host["y"], host["mask"])]
    fleet = pf.pack_fleet(panels, list(host["lds"]), dtype=torch.float64,
                          device="cpu")
    seg = PRODUCTS["seg"]
    if name == "simulate":
        out = pf.fleet_simulate(params, fleet, seg=seg)
    elif name == "simulate_filtered":
        out = pf.fleet_simulate(params, fleet, smooth=False)
    elif name == "decompose":
        out = pf.fleet_decompose(params, fleet, seg=seg)
    elif name == "innovations":
        out = pf.fleet_innovations(params, fleet,
                                   warmup=PRODUCTS["warmup"])
    elif name == "forecast":
        out = pf.fleet_forecast(params, fleet, PRODUCTS["steps"])
    else:  # the sample, through the card's normals
        k = normals[0].shape[0]
        phi, q, z, r = lanes_statespace(
            torch.as_tensor(params[:k]).T,
            fleet.loadings[:k].permute(1, 2, 0), fleet.dt[:k])
        x0, w, e = (draw_major(torch.as_tensor(a)) for a in normals)
        draws = _lanes_sample_given(
            phi, q, z, r, fleet.y[:k].permute(1, 2, 0),
            fleet.mask[:k].permute(1, 2, 0), x0.T, w.permute(1, 2, 0),
            e.permute(1, 2, 0), seg=seg, device="cpu")
        out = (draws.permute(3, 0, 1, 2),)  # (B, D, T, N)
    return [o.numpy() for o in out]


def phase_products_path(fit):
    """The port's post-fit products of the fitted flagship fleet on the
    card, under the JAX bench's product settings, in one dispatch each;
    CPU_MODELS models recomputed in f64 on the CPU meanwhile (worker
    processes, one per product)."""
    import numpy as np
    import torch

    from metran_tpu_torch.diagnostics import fleet_whiteness
    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.parallel import (
        fleet_decompose,
        fleet_forecast,
        fleet_innovations,
        fleet_sample,
        fleet_simulate,
    )
    from metran_tpu_torch.parallel.fleet import fleet_sample_normals

    fleet, params = fit["fleet"], fit["params"]
    seg, warmup = PRODUCTS["seg"], PRODUCTS["warmup"]
    n_draws, steps = PRODUCTS["n_draws"], PRODUCTS["steps"]
    idx = list(range(0, FLEET, FLEET // CPU_MODELS))
    idx_sample = idx[:2]
    # the CPU recompute: the card's fitted parameters, the same
    # f32-rounded observations, the card's normals for the sample
    normals = [a[idx_sample].double().cpu().numpy()
               for a in fleet_sample_normals(fleet, n_draws, SEED)]
    host = {"y": fit["y32"][idx].astype(np.float64),
            "mask": fit["mask"][idx], "lds": fit["lds"][idx]}
    p_cpu = params[idx].double().cpu().numpy()
    runs = {
        "simulate": lambda: fleet_simulate(params, fleet, seg=seg),
        "simulate_filtered": lambda: fleet_simulate(params, fleet,
                                                    smooth=False),
        "decompose": lambda: fleet_decompose(params, fleet, seg=seg),
        "innovations": lambda: fleet_innovations(params, fleet,
                                                 warmup=warmup),
        "forecast": lambda: fleet_forecast(params, fleet, steps),
        "sample": lambda: (fleet_sample(params, fleet, n_draws=n_draws,
                                        seed=SEED, seg=seg),),
    }
    t_cpu = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=len(PRODUCT_NAMES),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {name: pool.submit(cpu_product, name, host, p_cpu,
                                     normals if name == "sample" else None)
                   for name in PRODUCT_NAMES}
        out, stats = {}, {}
        reset_launches()
        with _KernelTimer() as timer:
            for name in PRODUCT_NAMES:
                before = launches()
                torch.cuda.synchronize()
                k0 = len(timer.events)
                t0 = time.perf_counter()
                out[name] = runs[name]()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                k_ms = timer.kernel_ms(k0)
                after = launches()
                stats[name] = {
                    "wall_ms": wall * 1e3, "kernel_ms": k_ms,
                    "models_per_s": FLEET / wall,
                    "device_busy": k_ms / (wall * 1e3),
                    "launches": {k: after[k] - before[k] for k in after
                                 if after[k] > before[k]},
                }
        counts = launches()
        t0 = time.perf_counter()
        white = fleet_whiteness(out["innovations"][0])
        whiteness_s = time.perf_counter() - t0
        cpu = {name: f.result() for name, f in futures.items()}
    cpu_s = time.perf_counter() - t_cpu
    for kern in ("lanes_filter", "lanes_smooth_bwd", "lanes_forward",
                 "lanes_sample", "forecast_moments"):
        require(counts[kern] > 0, f"products path never launched {kern}")

    # what comes out: finite where the JAX products are, variances >= 0,
    # innovations NaN exactly where masked or before warmup, draws
    # through every observed entry (r = 0)
    def finite(*ts):
        return all(bool(torch.isfinite(t).all()) for t in ts)

    y, mask = fleet.y, fleet.mask
    for name in ("simulate", "simulate_filtered", "forecast"):
        means, variances = out[name]
        require(finite(means, variances), f"{name}: non-finite output")
        require(bool((variances >= 0).all()), f"{name}: negative variance")
    require(finite(*out["decompose"]), "decompose: non-finite output")
    v, f = out["innovations"]
    steps_t = torch.arange(y.shape[1], device=y.device)[None, :, None]
    keep = mask & (steps_t >= warmup)
    for a in (v, f):
        require(torch.equal(torch.isfinite(a), keep)
                and bool(torch.isnan(a[~keep]).all()),
                "innovations: NaN not exactly at masked/warmup positions")
    require(bool((f[keep] >= 0).all()), "innovations: negative variance")
    (draws,) = out["sample"]
    require(finite(draws), "sample: non-finite draw")
    obs = mask[:, None].expand_as(draws)
    through = float((draws - y[:, None])[obs].abs().max())
    y_scale = float(y[mask].abs().max())
    require(through <= 1e-3 * y_scale,
            f"sample: draws miss observed entries by {through}")

    # the card's f32 products against the CPU f64 plain products
    errs = {}
    for name in PRODUCT_NAMES:
        sel = idx_sample if name == "sample" else idx
        errs[name] = [rel_err(o[sel].cpu(), torch.as_tensor(w))
                      for o, w in zip(out[name], cpu[name])]
    require(all(within(e, 1e-3) for e in errs.values()),
            f"card f32 vs CPU f64: {errs}")
    emit({
        "phase": "products_path", "fleet": FLEET, "t_steps": T_STEPS,
        "settings": PRODUCTS, "products": stats, "launches": counts,
        "whiteness": {"host_s": whiteness_s,
                      "white_frac_at_5pct": float(np.nanmean(
                          white.pvalue >= 0.05)),
                      "tested": int(np.isfinite(white.pvalue).sum())},
        "sample_through_observed_max_abs": through,
        "cpu_models": idx, "cpu_sample_models": idx_sample,
        "cpu_f64_rel_err": errs, "cpu_recompute_wall_s": cpu_s,
    })
    return counts


# the single-model path (phase 7)
EXAMPLE = "B21B0214"  # the reference's example model (examples/data)
GOLDEN = REPO / "tests" / "golden" / "metran_example.json"
#: the golden rows' bars (tests/test_metran.py)
GOLDEN_ROWS = {"state_means": ("state_means_rows", 2e-4),
               "state_variances": ("state_variances_rows", 2e-4),
               "simulated_means": ("simulated_means_rows", 2e-3),
               "simulated_variances": ("simulated_variances_rows", 2e-3),
               "decompose": ("decomposition_rows", 2e-3)}
METRAN_DRAWS = 16  # sample_simulation's draws (two chunks of 8 lanes)
CPU_DRAWS = 2  # draws recomputed on the CPU through the card's normals
#: the products compared with the CPU f64 recompute (frames of numbers)
METRAN_COMPARED = ("state_means", "state_variances", "simulated_means",
                   "simulated_variances", "decompose", "innovations",
                   "forecast")


def example_series():
    """The reference's example (5 series), as the verify recipe reads
    it."""
    import pandas as pd

    return [pd.read_csv(REPO / "examples" / "data" / f"{EXAMPLE}00{i + 1}_res.csv",
                        header=0, index_col=0, names=[f"{EXAMPLE}00{i + 1}"],
                        parse_dates=True, date_format="%Y-%m-%d")
            for i in range(5)]


def flagship_series(seed):
    """One model of the flagship configuration (20 series, 1 factor,
    5,000 daily steps, 30% missing) as pandas series, NaN where
    missing."""
    import numpy as np
    import pandas as pd

    y, mask, _, _, _ = make_workload(np.random.default_rng(seed), 1,
                                     t=T_STEPS)
    idx = pd.date_range("2000-01-01", periods=T_STEPS, freq="D")
    vals = np.where(mask[0], y[0], np.nan)
    return [pd.Series(vals[:, j], index=idx, name=f"s{j:02d}")
            for j in range(N_SERIES)]


def metran_products(mt, name, timer=None, keys=None):
    """The ``Metran`` products of ``mt`` for series ``name`` (those in
    ``keys``, default all): ``{product: value}`` and, with ``timer``,
    ``{product: {wall_ms, kernel_ms}}``.  ``filter+smoother`` runs the
    stored filter and its smoother once (K9 ``store`` and K10 on
    ``engine="sqrt"``, K6 ``store`` and K8 on ``"sequential"``); the
    accessors after it read that cache (the forecast adds K2, the sample
    K7 and the filter + mean-only smoother per chunk of draws)."""
    import torch

    runs = (
        ("filter+smoother", lambda: mt._run_kalman("smoother")),
        ("state_means", mt.get_state_means),
        ("state_variances", mt.get_state_variances),
        ("simulated_means", mt.get_simulated_means),
        ("simulated_variances", mt.get_simulated_variances),
        ("decompose", lambda: mt.decompose_simulation(name)),
        ("innovations", lambda: mt.get_innovations(warmup=50)),
        ("whiteness", mt.test_whiteness),
        ("forecast", lambda: mt.forecast(name, steps=FORECAST_STEPS)),
        ("sample", lambda: mt.sample_simulation(name, n_draws=METRAN_DRAWS,
                                                seed=SEED)),
        ("posterior_state", mt.to_posterior_state),
    )
    cuda = mt.device.type == "cuda"
    out, stats = {}, {}
    for key, fn in runs:
        if keys is not None and key not in keys and key != "filter+smoother":
            continue
        k0 = len(timer.events) if timer else 0
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[key] = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if timer:
            stats[key] = {"wall_ms": wall * 1e3,
                          "kernel_ms": timer.kernel_ms(k0)}
    return out, stats


def cpu_metran(kind, optimal, name, normals, engine):
    """The products of the example (``kind="example"``) or the flagship
    single model (``"flagship"``) at the card's fitted table
    ``optimal``, recomputed in f64 on the CPU with the plain versions of
    the card model's ``engine``, with the deviance there and the first
    CPU_DRAWS path draws through the card's normals ``(x0, w, e)``.
    Runs in a worker process; returns numpy arrays."""
    import numpy as np

    sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(1)
    from metran_tpu_torch import Metran
    from metran_tpu_torch.ops.kalman import _sample_states_given

    series = (example_series() if kind == "example"
              else flagship_series(SEED + 70))
    mt = Metran(series, name=kind, device="cpu", engine=engine)
    mt.get_factors(mt.oseries)
    mt.set_init_parameters()
    mt.parameters["optimal"] = optimal
    out, _ = metran_products(mt, name, keys=METRAN_COMPARED)
    res = {key: np.asarray(out[key].values, float)
           for key in METRAN_COMPARED}
    kf = mt.kf
    draws = _sample_states_given(kf.ss, kf.y, kf.mask, *normals,
                                 sm_data=kf.run_smoother().mean_s,
                                 engine=kf.draw_engine)
    col = list(mt.oseries.columns).index(name)
    z = mt.get_scaled_observation_matrix()[col]
    res["sample"] = (draws.numpy() @ z + mt.oseries_mean[col]).T
    # the deviance from the stored filter's terms (Metran.get_mle's value)
    res["deviance"] = kf.get_mle(mt.settings["warmup"])
    return res


def card_normals(mt, dev):
    """The first CPU_DRAWS standard normals of the card model's
    ``sample_simulation`` (its generator seed, its order), as f64
    numpy."""
    import torch

    from metran_tpu_torch.ops.kalman import _draw_normals

    gen = torch.Generator(dev).manual_seed(SEED)
    normals = _draw_normals(METRAN_DRAWS, len(mt.oseries), mt.nstate,
                            mt.nseries, gen, mt.dtype, dev)
    return [a[:CPU_DRAWS].double().cpu().numpy() for a in normals]


def phase_metran_path(pool):
    """The single-model ``Metran`` API on the card: (a) the example in
    f64 (``METRAN_TPU_X64=1``) on ``engine="sequential"``, solved by the
    card's default LanesSolve and held to the golden fit and rows; (a')
    the example in f64 on the card's default engine, ``"sqrt"``, at (a)'s
    fitted table, held to the golden rows and to (a)'s products within
    1e-9; (b) the example in f32 (default engine, ``"sqrt"``), held to
    the golden deviance; (c) one flagship model in f32 (``"sqrt"``); the
    products of (b) and (c) held to CPU f64 recomputes at the card's
    fitted tables, made in worker processes of ``pool`` while the card
    works.  The launch counters are reset before and read after the
    four; K3, K4, K6, K7, K8, K9, K10 and K2 must each have run."""
    import json
    import os

    import numpy as np
    import torch

    from metran_tpu_torch import LanesSolve, Metran
    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.serve.engine import posterior_fault

    golden = json.loads(GOLDEN.read_text())
    dev = torch.device(DEVICE)
    series = example_series()
    name_ex, name_f = f"{EXAMPLE}005", "s03"

    def solve(mt):
        torch.cuda.synchronize()
        k0, d0 = len(timer.events), len(timer.dispatches)
        t0 = time.perf_counter()
        mt.solve(report=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k_ms = timer.kernel_ms(k0)
        ffit = mt.fit.fleet_fit
        return {"solver": mt.settings["solver"], "fit_wall_s": wall,
                "kernel_ms": k_ms, "device_busy": k_ms / 1e3 / wall,
                "iterations": int(ffit.iterations[0]),
                "nfev": int(mt.fit.nfev),
                "converged": bool(ffit.converged[0]),
                "obj_func": mt.fit.obj_func,
                "dispatches": len(timer.dispatches) - d0}

    def checks_common(mt, out, name):
        """What comes out: finite, variances >= 0, innovations NaN exactly
        where unobserved or before the warmup, the draws through the
        observed values (r = 0), a finite serving state; returns the
        draws' largest miss relative to the data's scale."""
        for key in ("state_means", "state_variances", "simulated_means",
                    "simulated_variances", "decompose", "forecast"):
            require(np.isfinite(out[key].values).all(),
                    f"{key}: non-finite")
        for key in ("state_variances", "simulated_variances"):
            require((out[key].values >= 0).all(), f"{key}: negative")
        obs = mt.get_observations()
        keep = obs.notna().values.copy()
        keep[:50] = False
        require(np.array_equal(np.isfinite(out["innovations"].values), keep),
                "innovations: NaN not exactly at masked/warmup positions")
        require(out["whiteness"]["Q"].notna().all(), "whiteness: no Q")
        draws = out["sample"].values
        seen = obs[name].notna().values
        require(np.isfinite(draws).all(), "sample: non-finite draw")
        through = float(np.abs(draws[seen] - obs[name].values[seen, None])
                        .max())
        st = out["posterior_state"]
        require(np.isfinite(st.mean).all() and np.isfinite(st.cov).all(),
                "posterior state: non-finite")
        if mt._engine == "sqrt":
            require(st.chol is not None and posterior_fault(
                st.mean, st.cov, psd_tol=0.0, chol=st.chol) is None,
                "posterior state: no usable factor")
        return through / float(np.abs(obs[name].values[seen]).max())

    reset_launches()
    with _KernelTimer() as timer:
        # (a) the example in f64: the golden fit and rows
        os.environ["METRAN_TPU_X64"] = "1"
        try:
            mt64 = Metran(series, name=EXAMPLE, engine="sequential")
            mt64s = Metran(series, name=EXAMPLE)
        finally:
            del os.environ["METRAN_TPU_X64"]
        require(mt64.dtype == torch.float64 and mt64.device.type == "cuda",
                (mt64.dtype, mt64.device))
        require(mt64s._engine == "sqrt", f"card default {mt64s._engine}")
        fit64 = solve(mt64)
        require(isinstance(mt64.fit, LanesSolve), type(mt64.fit))
        obj_rel = abs(mt64.fit.obj_func - golden["obj_func"]) / golden[
            "obj_func"]
        opt = mt64.parameters["optimal"].values.astype(float)
        opt_rel = float(np.max(np.abs(opt - golden["optimal"])
                               / np.abs(golden["optimal"])))
        stderr = mt64.parameters["stderr"].values.astype(float)
        require(obj_rel <= 1e-5, f"f64 obj_func {mt64.fit.obj_func}")
        require(opt_rel <= 1e-3, f"f64 optimal {opt}")
        require(np.isfinite(stderr).all(), f"f64 stderr {stderr}")
        out64, stats64 = metran_products(mt64, name_ex, timer)
        rows = golden["state_means_rows_idx"]
        golden_err = {}
        # the golden decomposition is the first series'
        frames = {**out64,
                  "decompose": mt64.decompose_simulation(f"{EXAMPLE}001")}
        for key, (gkey, bar) in GOLDEN_ROWS.items():
            err = float(np.abs(frames[key].iloc[rows].values
                               - np.asarray(golden[gkey])).max())
            golden_err[key] = err
            require(err <= bar, f"f64 {key} rows off golden by {err}")
        mask = (0 * mt64.get_observations()).astype(bool)
        mask.loc["1997-8-28", name_ex] = True
        mt64.mask_observations(mask)
        masked = float(mt64.get_simulation(name_ex, alpha=None).loc[
            "1997-08-28"])
        mt64.unmask_observations()
        golden_err["masked_sim_1997"] = abs(
            masked - golden["masked_sim_1997"][0])
        require(golden_err["masked_sim_1997"] <= 2e-3,
                f"masked 1997-08-28 value {masked}")
        through64 = checks_common(mt64, out64, name_ex)

        # (a') the same example and table on the card's default engine,
        # the square-root one: the golden rows, and (a)'s products
        mt64s.get_factors(mt64s.oseries)
        mt64s.set_init_parameters()
        require(np.array_equal(mt64s.factors, mt64.factors),
                "f64 sqrt model: other factors")
        mt64s.parameters["optimal"] = mt64.parameters["optimal"]
        out64s, stats64s = metran_products(mt64s, name_ex, timer)
        frames_s = {**out64s,
                    "decompose": mt64s.decompose_simulation(f"{EXAMPLE}001")}
        golden_err_s = {}
        for key, (gkey, bar) in GOLDEN_ROWS.items():
            err = float(np.abs(frames_s[key].iloc[rows].values
                               - np.asarray(golden[gkey])).max())
            golden_err_s[key] = err
            require(err <= bar, f"f64 sqrt {key} rows off golden by {err}")
        through64s = checks_common(mt64s, out64s, name_ex)
        sqrt_vs_seq = {
            key: rel_err(torch.as_tensor(np.array(out64s[key].values,
                                                  float)),
                         torch.as_tensor(np.array(out64[key].values,
                                                  float)))
            for key in (*METRAN_COMPARED, "sample")}
        require(within(list(sqrt_vs_seq.values()), 1e-9),
                f"f64 sqrt vs sequential products: {sqrt_vs_seq}")

        # (b) the example in f32 (the card's precision and engine)
        mt32 = Metran(series, name=EXAMPLE)
        require(mt32.dtype == torch.float32, mt32.dtype)
        require(mt32._engine == "sqrt", f"card default {mt32._engine}")
        fit32 = solve(mt32)
        obj32_rel = abs(mt32.fit.obj_func - golden["obj_func"]) / golden[
            "obj_func"]
        require(obj32_rel <= 1e-3, f"f32 obj_func {mt32.fit.obj_func}")
        cpu_jobs = {"example_f32": (mt32, pool.submit(
            cpu_metran, "example", mt32.parameters["optimal"], name_ex,
            card_normals(mt32, dev), mt32._engine))}
        out32, stats32 = metran_products(mt32, name_ex, timer)
        through32 = checks_common(mt32, out32, name_ex)

        # (c) one flagship model in f32
        mtf = Metran(flagship_series(SEED + 70), name="flagship")
        require(mtf._engine == "sqrt", f"card default {mtf._engine}")
        fitf = solve(mtf)
        cpu_jobs["flagship_f32"] = (mtf, pool.submit(
            cpu_metran, "flagship", mtf.parameters["optimal"], name_f,
            card_normals(mtf, dev), mtf._engine))
        outf, statsf = metran_products(mtf, name_f, timer)
        throughf = checks_common(mtf, outf, name_f)
        counts = launches()
    for kern in ("lanes_filter", "lanes_adjoint", "lanes_forward",
                 "rts_smooth", "lanes_sample", "forecast_moments",
                 "sqrt_filter", "sqrt_smooth"):
        require(counts[kern] > 0, f"Metran path never launched {kern}")

    # the card's f32 products against the CPU f64 recomputes
    t0 = time.perf_counter()
    cpu_err = {}
    for label, (mt, out) in (("example_f32", (mt32, out32)),
                             ("flagship_f32", (mtf, outf))):
        cpu = cpu_jobs[label][1].result()
        errs = {key: rel_err(torch.as_tensor(np.array(out[key].values,
                                                      float)),
                             torch.as_tensor(cpu[key]))
                for key in METRAN_COMPARED}
        errs["sample"] = rel_err(
            torch.as_tensor(np.array(out["sample"].values[:, :CPU_DRAWS])),
            torch.as_tensor(cpu["sample"]))
        errs["deviance"] = abs(mt.fit.obj_func - cpu["deviance"]) / abs(
            cpu["deviance"])
        cpu_err[label] = errs
    cpu_wait = time.perf_counter() - t0
    require(all(within(list(e.values()), 1e-3) for e in cpu_err.values()),
            f"card f32 vs CPU f64: {cpu_err}")
    for label in cpu_err:
        require(cpu_err[label]["deviance"] <= 1e-4,
                f"{label}: card f32 deviance vs CPU f64 {cpu_err[label]}")
    emit({
        "phase": "metran_path", "launches": counts,
        "example_f64": {
            "engine": mt64._engine,
            "fit": fit64, "obj_rel_err": obj_rel, "optimal_rel_err": opt_rel,
            "stderr": stderr.tolist(), "golden_abs_err": golden_err,
            "products": stats64, "sample_through_observed_rel": through64},
        "example_f64_sqrt": {
            "engine": mt64s._engine, "golden_abs_err": golden_err_s,
            "products": stats64s, "rel_err_vs_sequential": sqrt_vs_seq,
            "sample_through_observed_rel": through64s},
        "example_f32": {"engine": mt32._engine,
                        "fit": fit32, "obj_rel_err_vs_f64_golden": obj32_rel,
                        "products": stats32,
                        "sample_through_observed_rel": through32},
        "flagship_f32": {"engine": mtf._engine, "fit": fitf,
                         "n_series": N_SERIES,
                         "t_steps": T_STEPS, "products": statsf,
                         "sample_through_observed_rel": throughf},
        "cpu_f64_rel_err": cpu_err, "cpu_wait_s": cpu_wait,
    })
    return counts, mt64, out64


# ----------------------------------------------------------------------
# bounded-cost serving: K14 (the steady append), K15 (the DARE solve),
# the steady serving path and fixed-lag smoothing
# ----------------------------------------------------------------------
STEADY_FORMS = (("off", False), ("reject", False), ("huber", False),
                ("inflate", False), ("reject", True), ("huber", True),
                ("inflate", True))
DARE_NEWTON, DARE_DOUBLING = 24, 32  # dare_solve's defaults


def k14_cost(z, kgain, mask, itemsize):
    """Bytes the K14 call must move (phi, Z, the gain, the variances,
    the real flags, the mean, the rows, the mask and the armed flags
    read once; the mean, sigma, detf, broke, the z-scores and the int8
    verdicts written once) and the least operations this run's data
    needs: per step the predict (S), and per observed slot the dot
    ``Z_i.m`` on the row's nonzeros, the z-score and its test, the gain
    column's product on its nonzeros and the two sums (~10)."""
    b, n, s = z.shape
    k = mask.shape[1]
    nbytes = (b * ((2 * s + 2 * n * s + n) * itemsize + n + 1)
              + b * k * n * (itemsize + 1)
              + b * (s + 2) * itemsize + b
              + b * k * n * (itemsize + 1))
    nnz_z = (z != 0).double().sum(-1)  # (B, N)
    nnz_k = (kgain != 0).double().sum(-2)  # (B, N): a gain column's
    per_slot = 2 * nnz_z + 2 * nnz_k + 10
    ops = float((mask.double() * per_slot[:, None, :]).sum()) + b * k * s
    return nbytes, ops


def k15_cost(z, itemsize, newton=DARE_NEWTON, doubling=DARE_DOUBLING):
    """Bytes the K15 call must move (phi, Q, Z and r read once; the two
    (S, S) covariances, the two (S, N) gains and the two (N,) variance
    vectors written once) and its float64 operations, keyed by rate:
    the matrix products, which the card's f64 tensor cores can run
    (``float64_tensor``), and the rest (``float64``).  The first
    Lyapunov solve has ``M = diag(phi)``, so each of its doubling steps
    scales S elementwise (3 S^2 + S, no product).  Per Newton step: the
    gain at P (``Z P`` and ``(Z P) Z'`` on Z's nonzeros; the Cholesky
    and cho_solve of F), ``A = Phi (I - K Z)`` (``K Z`` on Z's
    nonzeros), ``B = Phi K R K' Phi' + Q`` (2 S^2 N) and a doubling
    Lyapunov solve of dense products (6 S^3 a step, plus 3 S^2 for the
    sum and the symmetrisation).  Then the gains, ``p_filt`` (``K F``
    and ``(K F) K'``) and the per-slot scan (matrix-vector steps)."""
    b, n, s = z.shape
    nbytes = b * (s + s * s + n * s + n + 2 * s * s + 2 * s * n
                  + 2 * n) * itemsize
    nnz = float((z != 0).double().sum()) / max(b, 1)
    gain_prod = 2 * nnz * s + 2 * nnz * n
    gain_rest = n ** 3 / 3 + 2 * n * n * s + n * n
    prod = (newton * (gain_prod + 2 * nnz * s + 2 * s * s * n
                      + doubling * 6.0 * s ** 3)
            + gain_prod + 2 * s * n * n + 2 * s * s * n)
    rest = (doubling * (3.0 * s * s + s)
            + newton * (gain_rest + 3 * s * s + doubling * 3.0 * s * s
                        + 2 * s * s)
            + gain_rest + 2 * s * s + n * (2 * s * s + 2 * s + 3 * s * s))
    return nbytes, {"float64_tensor": b * prod, "float64": b * rest}


def dare_residual(p, phi, q, z, r):
    """``max|P - Phi (P - P Z' F^-1 Z P) Phi' - Q| / max|P|`` per model
    (float64, torch.linalg on the fixed point: a check, not the
    port)."""
    import torch

    p, phi, q, z, r = (t.double() for t in (p, phi, q, z, r))
    f = z @ p @ z.transpose(-1, -2) + torch.diag_embed(r)
    pz = p @ z.transpose(-1, -2)
    res = (p - phi[:, :, None] * (p - pz @ torch.linalg.solve(
        f, pz.transpose(-1, -2))) * phi[:, None, :] - q)
    return (res.abs().amax(dim=(1, 2)) / p.abs().amax(dim=(1, 2)))


def _scatter_gains(gains, n, kf, bucket, dtype):
    """True-dimension frozen gains into the bucket layout, as the
    service scatters them: ``(kgain, fdiag, kgain_seq, fdiag_seq)``."""
    import torch

    from metran_tpu_torch.serve.engine import state_slot_index

    n_pad, s_pad = bucket
    idx = torch.as_tensor(state_slot_index(n, kf, n_pad))
    out = []
    for kg, fd in ((gains[2], gains[3]), (gains[4], gains[5])):
        b = kg.shape[0]
        kp = torch.zeros((b, s_pad, n_pad), dtype=dtype, device=kg.device)
        kp[:, idx[:, None], torch.arange(n)[None, :]] = kg.to(dtype)
        fp = torch.ones((b, n_pad), dtype=dtype, device=kg.device)
        fp[:, :n] = fd.to(dtype)
        out += [kp, fp]
    return out


def _steady_bucket_case(rng, dtype, dev, k=1):
    """The flagship bucket (24, 32) at B = FLEET: the models' frozen
    gains from K15 (float64, true dimensions, scattered into the
    bucket), the mean after 64 fully observed steps (K1), then ``k``
    fully observed rows with a spike on one slot of each of the first
    GATE_SPIKED models, a masked cell on every 16th model and an armed
    mix (every fourth model disarmed).  Returns ``(phi, z, (kgain,
    fdiag, kgain_seq, fdiag_seq), real, mean, y, mask, armed)``."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import dare_gains, joint_filter_append
    from metran_tpu_torch.ops import dfm_statespace

    y, mask, lds, a_s, a_c = make_workload(rng, FLEET, t=64 + k,
                                           missing=0.0)
    true = dfm_statespace(a_s, a_c, lds, 1.0, device=dev,
                          dtype=torch.float64)
    gains = _scatter_gains(dare_gains(*true), N_SERIES, N_FACTORS, BUCKET,
                           dtype)
    n_pad, s_pad = BUCKET
    alpha_s = np.ones((FLEET, n_pad))
    alpha_s[:, :N_SERIES] = a_s
    alpha_c = np.ones((FLEET, s_pad - n_pad))
    alpha_c[:, :N_FACTORS] = a_c
    loadings = np.zeros((FLEET, n_pad, s_pad - n_pad))
    loadings[:, :N_SERIES, :N_FACTORS] = lds
    ss = dfm_statespace(alpha_s, alpha_c, loadings, 1.0, device=dev,
                        dtype=dtype)
    yp = torch.zeros((FLEET, 64 + k, n_pad), dtype=dtype, device=dev)
    yp[:, :, :N_SERIES] = torch.as_tensor(y, dtype=dtype, device=dev)
    mp = torch.zeros((FLEET, 64 + k, n_pad), dtype=torch.bool, device=dev)
    mp[:, :, :N_SERIES] = True
    mean0 = torch.zeros((FLEET, s_pad), dtype=dtype, device=dev)
    cov0 = torch.eye(s_pad, dtype=dtype, device=dev).expand(
        FLEET, s_pad, s_pad).contiguous()
    warm = joint_filter_append(*ss, mean0, cov0, yp[:, :64].contiguous(),
                               mp[:, :64].contiguous())
    y_k, m_k = yp[:, 64:].clone(), mp[:, 64:].clone()
    for b in range(min(GATE_SPIKED, FLEET)):
        y_k[b, b % k, b % N_SERIES] += GATE_SPIKE if b % 2 else -GATE_SPIKE
    for b in range(5, FLEET, 16):
        m_k[b, (b // 16) % k, (b * 7) % N_SERIES] = False
    real = torch.zeros((FLEET, n_pad), dtype=torch.bool, device=dev)
    real[:, :N_SERIES] = True
    armed = torch.tensor([b % 4 != 3 for b in range(FLEET)], device=dev)
    return (ss.phi, ss.z, gains, real, warm[0].contiguous(),
            y_k.contiguous(), m_k.contiguous(), armed)


def phase_steady_kernels():
    """K14 (the frozen-gain steady append) in every policy and form, and
    K15 (the DARE solve and the frozen gains), against their plain
    versions on the card; K9 ``store`` from a given carry (the fixed-lag
    window's filter).  K14 on the flagship bucket (B = 512, (24, 32),
    k = 1 and k = 4) with spikes on known slots, masked cells and an
    armed mix, f64 and f32 (normwise 1e-9 / 1e-3, NaN-strict; broke and
    the verdicts equal); K15 in f64 on the flagship fleet's 512 models
    at their true dimensions (20, 21) and in the four alpha regimes of
    the precision panel (1e-9, plus the DARE residual within 1e-10 of
    |P|), in f32 on the flagship models (1e-3) with its error against
    f64 reported per regime; K9 ``store`` from a non-triangular carry
    against its plain version and bit for bit the continuation of its
    own full store.  Then each timed at the main path's shapes beside
    its bound: K14 at B = 512, k = 1, f32, each policy and form; K15 in
    f64 for 1 model and for 512 in one launch."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import (
        dare_gains,
        dare_gains_plain,
        sqrt_filter,
        sqrt_filter_plain,
        steady_filter,
        steady_filter_plain,
    )
    from metran_tpu_torch.ops import chol_outer, dfm_statespace
    from metran_tpu_torch.ops.kalman import _lanes_ss

    dev = torch.device(DEVICE)
    thresh = GATE_NSIGMA ** 2
    checks, times, info = [], {}, {}

    def record(kernel, case, dtype, got, want, bar, exact=()):
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        same = [bool(torch.equal(got[i], want[i])) for i in exact]
        checks.append({
            "kernel": kernel, "case": case, "dtype": str(dtype)[6:],
            "rel_err": errs, "bar": bar, "exact_equal": same,
            "max_abs_err": max(abs_err(g, w) for g, w in zip(got, want)),
            "ok": within(errs, bar) and all(same)})

    for dtype in (torch.float64, torch.float32):
        bar = 1e-9 if dtype == torch.float64 else 1e-3
        for k in (1, 4):
            rng = np.random.default_rng(SEED + 110 + k)
            phi, z, g, real, mean, y, mask, armed = _steady_bucket_case(
                rng, dtype, dev, k)
            for policy, seq in STEADY_FORMS:
                kg, fd = (g[2], g[3]) if seq else (g[0], g[1])
                args = (phi, z, kg, fd, real, mean, y, mask, armed, policy,
                        thresh, seq)
                got = steady_filter(*args)
                want = steady_filter_plain(*args)
                torch.cuda.synchronize()
                form = "per-slot" if seq else "vector"
                case = f"{policy} {form}, B={FLEET} k={k} (24, 32)"
                record("steady_filter", case, dtype,
                       (got[0], got[1], got[2], got[4]),
                       (want[0], want[1], want[2], want[4]), bar)
                record("steady_filter", f"{case}: broke, verdicts", dtype,
                       [got[3].double(), got[5].double()],
                       [want[3].double(), want[5].double()], 0.0,
                       exact=(0, 1))
                masked = [b for b in range(5, FLEET, 16)]
                require(bool(got[3][masked].all()),
                        f"K14 {case}: a masked cell did not break the row")
                if policy != "off":
                    spiked = [b for b in range(min(GATE_SPIKED, FLEET))
                              if b % 4 != 3]
                    require(bool(got[5][spiked].any(-1).any(-1).all()),
                            f"K14 {case}: an armed spike passed the gate")
                    require(bool(got[3][spiked].all())
                            == (policy in ("reject", "inflate")),
                            f"K14 {case}: broke on a gate hit")
        # K15 on the flagship fleet's models, true dimensions
        rng = np.random.default_rng(SEED + 115)
        _, _, lds, a_s, a_c = make_workload(rng, FLEET, t=2)
        true = dfm_statespace(a_s, a_c, lds, 1.0, device=dev, dtype=dtype)
        got = dare_gains(*true)
        want = dare_gains_plain(*true)
        torch.cuda.synchronize()
        record("dare", f"B={FLEET} (N, S)=(20, 21), flagship", dtype, got,
               want, bar)
        if dtype == torch.float64:
            res = float(dare_residual(got[0], *true).max())
            info["flagship_residual_f64"] = res
            require(res <= 1e-10, f"K15 f64 DARE residual {res}")
            ref64 = want
        else:
            info["flagship_f32_vs_f64"] = max(
                rel_err(g, w) for g, w in zip(got, ref64))
    # K15 in the four alpha regimes of the precision panel
    _, _, loadings = make_precision_panel()
    n = PREC_N
    alphas = dict(PREC_ALPHAS)
    alphas["mixed"] = list(np.linspace(0.1, 100.0, n)) + [1e4]
    names = list(alphas)
    a = np.array([alphas[key] for key in names])
    ld = np.broadcast_to(loadings, (len(names), n, PREC_K))
    ss64 = dfm_statespace(a[:, :n], a[:, n:], ld, 1.0, device=dev,
                          dtype=torch.float64)
    got = dare_gains(*ss64)
    want = dare_gains_plain(*ss64)
    torch.cuda.synchronize()
    record("dare", "the 4 alpha regimes (20, 21)", torch.float64, got, want,
           1e-9)
    res = dare_residual(got[0], *ss64)
    ss32 = dfm_statespace(a[:, :n], a[:, n:], ld, 1.0, device=dev,
                          dtype=torch.float32)
    got32 = dare_gains(*ss32)
    torch.cuda.synchronize()
    regimes = {}
    for i, name in enumerate(names):
        r = float(res[i])
        require(r <= 1e-10, f"K15 f64 residual in regime {name}: {r}")
        regimes[name] = {
            "residual_f64": r,
            "f32_vs_f64_rel": {
                field: rel_err(g32[i], g64[i]) for field, g32, g64 in zip(
                    ("p_pred", "p_filt", "kgain", "fdiag", "kgain_seq",
                     "fdiag_seq"), got32, got)},
            "f32_residual": float(dare_residual(got32[0][i:i + 1],
                                                *(t[i:i + 1]
                                                  for t in ss64))[0]),
            "f32_finite": all(bool(torch.isfinite(t[i]).all())
                              for t in got32)}
    info["regimes"] = regimes
    # K9 store from a given carry: the fixed-lag window's filter
    for dtype in (torch.float64, torch.float32):
        bar = 1e-9 if dtype == torch.float64 else 1e-3
        rng = np.random.default_rng(SEED + 116)
        yw, mw, lds, a_s, a_c = make_workload(rng, 16, t=160)
        ss = dfm_statespace(a_s, a_c, lds, 1.0, device=dev, dtype=dtype)
        lanes = _lanes_ss(ss, "sqrt")
        yt = torch.as_tensor(yw, dtype=dtype, device=dev)
        mt = torch.as_tensor(mw, device=dev)
        full = sqrt_filter(*lanes, yt, mt, store=True)
        cut = 96
        # a non-triangular factor of the carry (rotated by a fixed
        # orthogonal matrix), as a migrated state's is
        rot = torch.linalg.qr(torch.as_tensor(
            rng.normal(size=(N_SERIES + 1, N_SERIES + 1)), dtype=dtype,
            device=dev)).Q
        m0 = full[2][:, cut - 1].contiguous()
        c0 = (full[3][:, cut - 1] @ rot).contiguous()
        rest = (yt[:, cut:].contiguous(), mt[:, cut:].contiguous())
        got = sqrt_filter(*lanes, *rest, store=True, mean0=m0, chol0=c0)
        want = sqrt_filter_plain(*lanes, *rest, store=True, mean0=m0,
                                 chol0=c0)
        torch.cuda.synchronize()
        record("sqrt_filter", "store from a given non-triangular carry, "
               "16 lanes, 64 steps", dtype,
               (got[0], chol_outer(got[1]), got[2], chol_outer(got[3]),
                got[4], got[5]),
               (want[0], chol_outer(want[1]), want[2], chol_outer(want[3]),
                want[4], want[5]), bar)
        again = sqrt_filter(*lanes, *rest, store=True, mean0=m0,
                            chol0=full[3][:, cut - 1].contiguous())
        torch.cuda.synchronize()
        same = all(torch.equal(g, f[:, cut:]) for g, f in zip(again, full))
        info[f"k9_store_from_carry_continues_bitwise_{str(dtype)[6:]}"] = \
            same
        require(same, "K9 store from its own carry is not its full store's "
                "continuation bit for bit")
    for c in checks:
        emit({"phase": "kernel_check", **c})
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"kernel disagrees with its plain version: {bad}")

    # the main path's shapes: K14 at B = 512, k = 1, f32; K15 in f64
    dtype = torch.float32
    rng = np.random.default_rng(SEED + 117)
    phi, z, g, real, mean, y, mask, armed = _steady_bucket_case(rng, dtype,
                                                                dev)
    n_b, s_b = z.shape[1:]
    for policy, seq in STEADY_FORMS:
        kg, fd = (g[2], g[3]) if seq else (g[0], g[1])
        args = (phi, z, kg, fd, real, mean, y, mask, armed, policy, thresh,
                seq)
        ms, _ = cuda_ms(lambda a=args: steady_filter(*a))
        plain_ms, _ = cuda_ms(lambda a=args: steady_filter_plain(*a), reps=5,
                              warm=1)
        bms, bby = bound_ms(*k14_cost(z, kg, mask, 4), "float32")
        form = "slot" if seq else "vector"
        key = ("steady_filter" if (policy, seq) == ("reject", True)
               else f"steady_filter_{policy}_{form}")
        times[key] = {
            "shape": f"{policy} {form}, B={FLEET} k=1 N={n_b} S={s_b} f32 "
                     "(steady update dispatch)",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": bby}
    _, _, lds, a_s, a_c = make_workload(np.random.default_rng(SEED + 118),
                                        FLEET, t=2)
    true = dfm_statespace(a_s, a_c, lds, 1.0, device=dev,
                          dtype=torch.float64)
    one = type(true)(*(t[:1].contiguous() for t in true))
    for key, ss_t, reps in (("dare", true, 5), ("dare_one_model", one, 10)):
        ms, _ = cuda_ms(lambda s=ss_t: dare_gains(*s), reps=reps, warm=1)
        plain_ms, _ = cuda_ms(lambda s=ss_t: dare_gains_plain(*s), reps=3,
                              warm=1)
        bms, bby = bound_ms(*k15_cost(ss_t.z, 8), "float64")
        times[key] = {
            "shape": f"B={ss_t.z.shape[0]} (N, S)=(20, 21) f64, "
                     f"{DARE_NEWTON} Newton x {DARE_DOUBLING} doubling "
                     "(a freeze group)",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": bby}
    emit({"phase": "steady_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar",
                           "ok")} for c in checks], **info, "times": times})
    return checks, times


STEADY_HIST = 400  # the fully observed history (bench.py::run_steady_bench)
STEADY_ROUNDS = 12  # k = 1 update rounds of each steady run
STEADY_TOL = {"float32": 1e-4, "float64": 1e-9}  # tests/test_steady.py _TOL
STEADY_DEV = {"float32": 2e-3, "float64": 1e-8}  # ... and _DEV_BOUND
STEADY_MIN_SEEN = 256  # SteadySpec's default floor
STEADY_F64_MODELS = 64
STEADY_THAWS = 8  # models thawed by a NaN cell, and by a spike, each
STEADY_SPIKE_SD = 30.0  # the spikes, in one-step predictive sds


def _steady_run(engine, dtype, batch, gate, detect, thaws, seed):
    """One steady service and its exact twin on the same fleet and
    stream (module doc of :func:`phase_steady_serving`); returns the
    run's summary, whose ``launches`` are the steady service's own: the
    sum of the launch deltas around its dispatches (freezes and thaws
    included), not the history pass, the twin or the spikes' sizing."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import launches
    from metran_tpu_torch.ops import (
        chol_outer,
        dfm_statespace,
        kalman_filter,
        sqrt_kalman_filter,
    )
    from metran_tpu_torch.serve import (
        MetranService,
        ModelRegistry,
        PosteriorState,
        SteadySpec,
    )

    dev = torch.device(DEVICE)
    npd = np.float32 if dtype == "float32" else np.float64
    sqrt = engine == "sqrt"
    rng = np.random.default_rng(seed)
    y, mask, lds, a_s, a_c = make_workload(
        rng, batch, t=STEADY_HIST + STEADY_ROUNDS + 2, missing=0.0)
    ss = dfm_statespace(a_s.astype(npd), a_c.astype(npd), lds.astype(npd),
                        1.0, device=dev)
    yh = y[:, :STEADY_HIST].astype(npd)
    mh = mask[:, :STEADY_HIST]
    if sqrt:
        res = sqrt_kalman_filter(ss, yh, mh, store=False)
        chols = res.chol_f.cpu().numpy()
        covs = chol_outer(res.chol_f).cpu().numpy()
    else:
        res = kalman_filter(ss, yh, mh, engine="joint", store=False)
        covs, chols = res.cov_f.cpu().numpy(), [None] * batch
    means = res.mean_f.cpu().numpy()
    rows = y[:, STEADY_HIST:].astype(npd)
    names = tuple(f"s{j}" for j in range(N_SERIES))
    ids = [f"m{i}" for i in range(batch)]
    states = [PosteriorState(
        model_id=ids[i], version=0, t_seen=STEADY_HIST, mean=means[i],
        cov=covs[i], params=np.concatenate([a_s[i], a_c[i]]).astype(npd),
        loadings=lds[i].astype(npd), dt=1.0,
        scaler_mean=np.zeros(N_SERIES, npd),
        scaler_std=np.ones(N_SERIES, npd), names=names, chol=chols[i])
        for i in range(batch)]
    svcs = {}
    for kind, tol in (("steady", STEADY_TOL[dtype]), ("exact", 0.0)):
        reg = ModelRegistry(root=None, engine=engine)
        for st in states:
            reg.put(st, persist=False)
        svcs[kind] = MetranService(
            reg, flush_deadline=None, max_batch=4096, persist_updates=False,
            gate=gate, detect=detect,
            steady=SteadySpec(tol=tol, min_seen=STEADY_MIN_SEEN),
            device=dev)
    svc_s, svc_e = svcs["steady"], svcs["exact"]

    own = dict.fromkeys(launches(), 0)  # the steady service's launches

    def tick(svc, obs):
        before = launches()
        futs = [svc.update_async(mid, obs[i]) for i, mid in enumerate(ids)]
        t0 = time.perf_counter()
        svc.flush()
        dt = time.perf_counter() - t0
        after = launches()
        bad = [f.exception() for f in futs if f.exception() is not None]
        require(not bad, f"a steady-run update failed: {bad[:1]}")
        delta = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        if svc is svc_s:
            for k, v in delta.items():
                own[k] += v
        return dt, delta

    def deviation(sel=None):
        sel = range(batch) if sel is None else sel
        return max(float(np.abs(
            svc_s.registry.get(ids[i]).mean.astype(float)
            - svc_e.registry.get(ids[i]).mean.astype(float)).max())
            for i in sel)

    times = {"steady": [], "exact": []}
    per_dispatch, frozen_after = [], None
    for r in range(STEADY_ROUNDS):
        obs = rows[:, r:r + 1]
        order = ("steady", "exact") if r % 2 == 0 else ("exact", "steady")
        for kind in order:
            dt, delta = tick(svcs[kind], obs)
            times[kind].append(dt)
            if kind == "steady" and r >= 1:
                per_dispatch.append(delta)
        if r == 0:
            frozen_after = svc_s._steady_count()
        if r == STEADY_ROUNDS - 2:
            covs_prev = {mid: svc_e.registry.get(mid).cov for mid in ids}
    frozen = svc_s._steady_count()
    bar = STEADY_DEV[dtype]
    dev_max = deviation()
    not_frozen = [mid for mid in ids if mid not in svc_s._steady_info]
    last_delta = {mid: float(np.abs(svc_e.registry.get(mid).cov
                                    - covs_prev[mid]).max())
                  for mid in not_frozen[:8]}
    # every model freezes on the first exact commit (a K15 that fails
    # for any group of candidates leaves it exact, and shows here)
    require(frozen_after == batch and frozen == batch,
            f"{engine} {dtype}: {frozen_after} then {frozen} of {batch} "
            f"models frozen (last deltas {last_delta})")
    require(dev_max <= bar, f"{engine} {dtype}: frozen vs exact mean "
            f"deviation {dev_max} over the bar {bar}")
    want = {"steady_filter": 1}
    if detect is not None:
        want["detect"] = 1
    require(all(d == want for d in per_dispatch),
            f"launches per steady dispatch: {per_dispatch}")
    out = {"engine": engine, "dtype": dtype, "models": batch,
           "gate": None if gate is None else gate._asdict(),
           "detect": detect is not None, "tol": STEADY_TOL[dtype],
           "frozen_after_first_round": frozen_after, "frozen": frozen,
           "not_frozen_last_delta": last_delta,
           "max_mean_deviation": dev_max, "bar": bar,
           "launches_per_steady_dispatch": per_dispatch[-1],
           "dispatch_ms": {kind: float(np.median(t[2:]) * 1e3)
                           for kind, t in times.items()},
           "throughput_ratio": float(np.median(
               np.asarray(times["exact"][2:])
               / np.asarray(times["steady"][2:])))}
    if thaws:
        # a NaN cell on STEADY_THAWS frozen models, a spike on as many
        # others and an external put of one more: each thaws, replays
        # through the exact update in the same dispatch and then matches
        # its twin
        frozen_ids = [i for i in range(batch)
                      if ids[i] in svc_s._steady_info][:2 * STEADY_THAWS + 1]
        require(len(frozen_ids) == 2 * STEADY_THAWS + 1,
                "too few frozen models for the thaw checks")
        nan_m = frozen_ids[:STEADY_THAWS]
        spike_m = frozen_ids[STEADY_THAWS:2 * STEADY_THAWS]
        put_m = frozen_ids[-1]
        obs = rows[:, STEADY_ROUNDS:STEADY_ROUNDS + 1].copy()
        sd = np.sqrt(np.stack([f.variances[0] for f in svc_e.forecast_batch(
            [ids[i] for i in spike_m], 1)]))
        for j, i in enumerate(nan_m):
            obs[i, 0, j % N_SERIES] = np.nan
        for j, i in enumerate(spike_m):
            obs[i, 0, j % N_SERIES] += STEADY_SPIKE_SD * sd[j, j % N_SERIES]
        st = svc_s.registry.get(ids[put_m])
        svc_s.registry.put(st._replace(params=np.array(st.params),
                                       loadings=np.array(st.loadings)),
                           persist=False)
        thaw0 = svc_s.steady_transitions.snapshot().get("thaw", 0)
        for svc in (svc_s, svc_e):
            tick(svc, obs)
        thawed = svc_s.steady_transitions.snapshot().get("thaw", 0) - thaw0
        # a spike thaws through a reject gate; ungated, the frozen gain
        # absorbs it as the exact update would, and the model stays
        sel = nan_m + (spike_m if gate is not None else []) + [put_m]
        still = [ids[i] for i in sel if ids[i] in svc_s._steady_info]
        dev_thawed = deviation(sel)
        require(thawed == len(sel) and not still,
                f"thaws: {thawed} of {len(sel)} (still frozen {still})")
        if gate is None:
            require(all(ids[i] in svc_s._steady_info for i in spike_m),
                    "an ungated spike thawed a model")
        require(dev_thawed <= bar, f"thawed models vs their twin: "
                f"{dev_thawed} over {bar}")
        if gate is not None:
            rej_s = svc_s.gate_verdicts.snapshot().get("rejected", 0)
            rej_e = svc_e.gate_verdicts.snapshot().get("rejected", 0)
            require(rej_s == rej_e and rej_s >= STEADY_THAWS,
                    f"rejected spikes: steady {rej_s}, exact {rej_e}")
        out["thaws"] = {"nan_cells": len(nan_m), "spikes": len(spike_m),
                        "spikes_thaw": gate is not None,
                        "external_puts": 1, "thawed": thawed,
                        "max_mean_deviation_thawed": dev_thawed}
        for svc in (svc_s, svc_e):
            tick(svc, rows[:, STEADY_ROUNDS + 1:])
        out["max_mean_deviation_after"] = deviation()
        require(out["max_mean_deviation_after"] <= bar,
                f"after the thaws: {out['max_mean_deviation_after']}")
    out["health_steady"] = svc_s.health()["steady"]
    out["launches"] = own
    for svc in svcs.values():
        svc.close()
    return out


def phase_steady_serving():
    """The bounded-cost serving path through the entry points a user
    calls: ``MetranService(registry, steady=SteadySpec(tol,
    min_seen=256))`` against its exact twin (``tol = 0``), both on the
    flagship fleet's 512 models in f32 after a fully observed 400-step
    history pass (the JAX steady bench's shape), assimilating the same
    12 rows of the fleet's continuation in paired, interleaved rounds:
    on the joint registry with ``GateSpec("reject", nsigma=12)`` and
    detection (the exact twin is K12 gated + K13; frozen models are K14
    per-slot + K13), and on the square-root registry ungated (K9 / K14
    vector form); freezes solve K15.  Checks: models freeze after the
    first round, every steady dispatch of frozen models is one K14
    launch (+ one K13), the frozen-vs-exact mean deviation within the
    JAX test's ``_DEV_BOUND`` (f32 2e-3) at ``_TOL`` = 1e-4; then NaN
    cells on 8 frozen models, 30-sigma spikes on 8 others and an
    external put of one more — each thaws, replays through the exact
    update in the same dispatch and matches its twin, the rejected
    counts equal.  Then 64 models in f64 at tol 1e-9 (bar 1e-8).
    Reports models frozen, freeze and thaw counts, the deviation beside
    tol, the last covariance delta of models that did not freeze and
    the steady-vs-exact dispatch ratio.  Returns the steady services'
    own launch counts (summed around their dispatches: not the history
    passes, the exact twins or the spikes' sizing)."""
    from metran_tpu_torch.serve import DetectSpec, GateSpec

    runs = [
        _steady_run("joint", "float32", FLEET,
                    GateSpec(policy="reject", nsigma=12.0, min_seen=1),
                    DetectSpec(enabled=True), True, SEED + 120),
        _steady_run("sqrt", "float32", FLEET, None, None, True, SEED + 121),
        _steady_run("joint", "float64", STEADY_F64_MODELS,
                    GateSpec(policy="reject", nsigma=12.0, min_seen=1),
                    None, False, SEED + 122),
    ]
    counts = {key: sum(r["launches"][key] for r in runs)
              for key in runs[0]["launches"]}
    for key in ("steady_filter", "dare", "gated_filter", "sqrt_filter",
                "detect"):
        require(counts[key] > 0, f"steady serving never launched {key}")
    emit({"phase": "steady_serving", "runs": runs, "launches": counts})
    return counts, {r["engine"] + "_" + r["dtype"]: r["dispatch_ms"]
                    for r in runs}


FIXED_LAG = 16  # the service's window
FIXED_LAG_MODELS = 32
FIXED_LAG_ROUNDS = 24
FIXED_LAG_OPS_L = 64  # the ops-level window on one flagship model


def phase_fixed_lag():
    """Fixed-lag smoothing on the card.  Ops level, on one flagship
    model (400 steps, 30% missing), f64 and f32: ``fixed_lag_smooth``
    over the last 64 steps from the full filter's carry (K9 ``store``
    from the carry, then K10) bit for bit the full ``sqrt_kalman_filter``
    + ``sqrt_rts_smoother``'s last 64 steps.  Then the path:
    ``MetranService(ModelRegistry(engine="sqrt"), fixed_lag=16)`` on 32
    flagship models (f32 posteriors after a 400-step history) over 24
    rounds of k = 1 (30% missing), so the anchor advances; every
    model's ``smoothed()`` window held to the card's full filter and
    smoother over the same rows from the posterior the window started
    at (the tracker works in f64, as the JAX package's does), normwise
    1e-5, and reported whether bitwise; ``smoothed()`` wall and one
    tracker advance timed.  Returns the path's launch counts, read
    right after the ``smoothed()`` calls: the references and the
    advance probe run after that."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import launches, reset_launches, sqrt_filter
    from metran_tpu_torch.ops import (
        SqrtFilterResult,
        chol_outer,
        dfm_statespace,
        fixed_lag_smooth,
        project,
        sqrt_kalman_filter,
        sqrt_rts_smoother,
    )
    from metran_tpu_torch.ops.kalman import _lanes_ss
    from metran_tpu_torch.serve import (
        FixedLagTracker,
        MetranService,
        ModelRegistry,
        PosteriorState,
    )

    dev = torch.device(DEVICE)
    out = {"ops": {}}
    lag = FIXED_LAG_OPS_L
    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(SEED + 130)
        y, mask, lds, a_s, a_c = make_workload(rng, 1, t=T_CMP)
        ss = dfm_statespace(a_s[0], a_c[0], lds[0], 1.0, device=dev,
                            dtype=dtype)
        yt = torch.as_tensor(y[0], dtype=dtype, device=dev)
        mt = torch.as_tensor(mask[0], device=dev)
        filt = sqrt_kalman_filter(ss, yt, mt)
        full = sqrt_rts_smoother(ss, filt)
        t = T_CMP
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        win = fixed_lag_smooth(ss, filt.mean_f[t - lag - 1],
                               filt.chol_f[t - lag - 1], yt[t - lag:],
                               mt[t - lag:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        same = (torch.equal(win.mean_s, full.mean_s[t - lag:])
                and torch.equal(win.chol_s, full.chol_s[t - lag:]))
        out["ops"][str(dtype)[6:]] = {"bitwise": same,
                                      "window_wall_ms": wall * 1e3}
        require(same, f"fixed_lag_smooth {dtype} is not the full smoother's "
                "last steps bit for bit")

    rng = np.random.default_rng(SEED + 131)
    b, rounds = FIXED_LAG_MODELS, FIXED_LAG_ROUNDS
    y, mask, lds, a_s, a_c = make_workload(rng, b, t=STEADY_HIST + rounds)
    f32 = np.float32
    ss = dfm_statespace(a_s.astype(f32), a_c.astype(f32), lds.astype(f32),
                        1.0, device=dev)
    res = sqrt_kalman_filter(ss, y[:, :STEADY_HIST].astype(f32),
                             mask[:, :STEADY_HIST], store=False)
    chols = res.chol_f.cpu().numpy()
    means = res.mean_f.cpu().numpy()
    names = tuple(f"s{j}" for j in range(N_SERIES))
    ids = [f"m{i}" for i in range(b)]
    reg = ModelRegistry(root=None, engine="sqrt")
    for i in range(b):
        reg.put(PosteriorState(
            model_id=ids[i], version=0, t_seen=STEADY_HIST, mean=means[i],
            cov=chols[i] @ chols[i].T,
            params=np.concatenate([a_s[i], a_c[i]]).astype(f32),
            loadings=lds[i].astype(f32), dt=1.0,
            scaler_mean=np.zeros(N_SERIES, f32),
            scaler_std=np.ones(N_SERIES, f32), names=names, chol=chols[i]),
            persist=False)
    rows = np.where(mask[:, STEADY_HIST:], y[:, STEADY_HIST:],
                    np.nan).astype(f32)
    # the path's own launches: the service's updates and smoothed()
    reset_launches()
    svc = MetranService(reg, flush_deadline=None, max_batch=4096,
                        persist_updates=False, fixed_lag=FIXED_LAG,
                        device=dev)
    first = None
    for r in range(rounds):
        futs = [svc.update_async(mid, rows[i, r][None])
                for i, mid in enumerate(ids)]
        svc.flush()
        require(all(f.exception() is None for f in futs),
                "a fixed-lag run update failed")
        if r == 0:
            first = [reg.get(mid) for mid in ids]
    torch.cuda.synchronize()
    walls, windows = [], []
    for mid in ids:
        t0 = time.perf_counter()
        windows.append(svc.smoothed(mid))
        walls.append(time.perf_counter() - t0)
    counts = launches()
    for key in ("sqrt_filter", "sqrt_smooth"):
        require(counts[key] > 0, f"fixed-lag path never launched {key}")
    errs, bitwise = [], True
    for i, (mid, got) in enumerate(zip(ids, windows)):
        require(got.lag == FIXED_LAG and got.t_end == STEADY_HIST + rounds,
                f"{mid}: window {got.lag} ending {got.t_end}")
        # the reference: the card's full square-root filter (K9 store
        # from the posterior the window started at) and smoother (K10)
        # over every row since, in f64 as the tracker runs
        st = first[i]
        n = N_SERIES
        ss64 = dfm_statespace(st.params[None, :n].astype(float),
                              st.params[None, n:].astype(float),
                              st.loadings[None].astype(float), 1.0,
                              device=dev)
        rest = rows[i, 1:]
        m_r = np.isfinite(rest)
        filt = SqrtFilterResult(*sqrt_filter(
            *_lanes_ss(ss64, "sqrt"),
            torch.as_tensor(np.where(m_r, rest, 0.0)[None], device=dev,
                            dtype=torch.float64),
            torch.as_tensor(m_r[None], device=dev), store=True,
            mean0=torch.as_tensor(st.mean[None], device=dev,
                                  dtype=torch.float64),
            chol0=torch.as_tensor(st.chol[None], device=dev,
                                  dtype=torch.float64)))
        full = sqrt_rts_smoother(ss64, filt)
        ref_mean = full.mean_s[0, -FIXED_LAG:]
        ref_means, ref_vars = project(
            ss64.z[0], ref_mean, chol_outer(full.chol_s[0, -FIXED_LAG:]))
        ref = [t.cpu().numpy() for t in (ref_mean, ref_means, ref_vars)]
        mine = [got.state_means, got.means, got.variances]
        bitwise &= all(np.array_equal(a_, b_) for a_, b_ in zip(mine, ref))
        errs.append(max(rel_err(torch.as_tensor(a_), torch.as_tensor(b_))
                        for a_, b_ in zip(mine[:2], ref[:2])))
    # one tracker advance: a copy of one model's window takes one row
    tr = FixedLagTracker(FIXED_LAG, device=dev)
    tr.restore({ids[0]: svc.smoother.dump()[ids[0]]})
    row = np.zeros((1, N_SERIES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.observe(ids[0], row, np.ones((1, N_SERIES), bool),
               STEADY_HIST + rounds + 1, lambda: None)
    torch.cuda.synchronize()
    advance = time.perf_counter() - t0
    require(within(errs, 1e-5), f"smoothed() vs the full smoother: {errs}")
    svc.close()
    out.update({
        "models": b, "rounds": rounds, "lag": FIXED_LAG,
        "max_rel_err_vs_full": max(errs), "bitwise_vs_full": bitwise,
        "smoothed_wall_ms_median": float(np.median(walls) * 1e3),
        "smoothed_wall_ms_max": float(np.max(walls) * 1e3),
        "tracker_advance_ms": advance * 1e3,
        "health_fixed_lag": svc.health()["fixed_lag"], "launches": counts})
    emit({"phase": "fixed_lag", **out})
    return counts


# ----------------------------------------------------------------------
# the state arena (B13): K16, K17, K18 and ModelRegistry(arena=True)
# ----------------------------------------------------------------------
ARENA_ROWS = 1024  # the JAX default arena_rows (metran_tpu/config.py:176)
ARENA_HIST = 64  # steps of the warm-up filter behind the kernel checks
ARENA_ROUNDS = 5  # paired update rounds of each arena serving run (the
#                   poisoned model's breaker opens after 5 failures)
ARENA_STEADY_ROUNDS = 8  # the same for the steady runs
ARENA_EVICT_ROWS, ARENA_EVICT_MODELS = 64, 96
ARENA_EVICT_CHUNK = 32  # models per dispatch of the eviction run
ARENA_POISONED = 7  # the model whose mean is NaN in the serving runs
ARENA_DET = dict(cusum_k=0.5, cusum_h=12.0, lb_window=64, lb_thresh=25.0,
                 nsigma=5.0)  # DetectSpec's defaults, as kernel params
# K16's checks: (body, mode, robust likelihood, detection, steady_tol)
ARENA_K16_MODES = (
    ("joint", "off", None, False, 1e-4),
    ("gated", "off", None, False, 0.0),
    ("gated", "reject", None, True, 1e-4),
    ("gated", "huber", None, False, 0.0),
    ("gated", "inflate", None, True, 0.0),
    ("gated", "off", "censored", True, 0.0),
    ("sqrt", "off", None, False, 1e-4),
    ("sqrt", "reject", None, True, 0.0),
    ("sqrt", "off", "quantized", False, 0.0),
)
ARENA_K17_MODES = (("off", False, False), ("reject", True, True),
                   ("huber", False, True))


def gate_cost(b, s, sqrt):
    """Operations of the arena's integrity gate on ``b`` rows: a factor
    row's ``F F'`` on the lower triangles (~s^3/3); a covariance row's
    symmetry test and ``sym(F) + jitter`` (~4 s^2) and the jittered
    Cholesky (~s^3/3).  Finiteness tests are not counted."""
    return b * (s ** 3 / 3.0 + (0 if sqrt else 4 * s * s))


def arena_tail_cost(b, n, s, k, itemsize, det):
    """Bytes and operations an arena update adds to its step body's: the
    row indices and ``t_seen`` read, ``t_seen``/``version`` written, the
    ok and conv flags; with detection the (6, N) state read and written
    and the counts and stats written, K13's ~30 operations per slot
    step."""
    nbytes = b * (4 + 4 + 8 + 4 + 2)
    ops = 0.0
    if det:
        nbytes += b * (2 * 6 * n * itemsize + 3 * n * 4 + 3 * n * itemsize)
        ops += 30.0 * b * k * n
    return nbytes, ops


def record_rows(checks, kernel, case, dtype, names, got, want, bar,
                exact=()):
    """One kernel-vs-plain check into ``checks``: each compared tensor held
    row by row (:func:`row_rel_err`), the ``exact`` pairs equal; the
    largest absolute error is reported with its field, row and that row's
    scale."""
    import torch

    errs = [row_rel_err(g, w) for g, w in zip(got, want)]
    same = [bool(torch.equal(a, b)) for a, b in exact]
    absd = [abs_err(g, w) for g, w in zip(got, want)]
    at = max(range(len(absd)), key=absd.__getitem__)
    g, w = got[at].double(), want[at].double()
    diff = torch.where(torch.isfinite(w), g - w,
                       torch.zeros_like(w)).abs()
    row = int(diff.reshape(diff.shape[0], -1).amax(1).argmax())
    wr = w[row][torch.isfinite(w[row])]
    checks.append({
        "kernel": kernel, "case": case, "dtype": str(dtype)[6:],
        "fields": names, "rel_err": errs, "norm": "per row",
        "bar": bar, "exact_equal": same, "max_abs_err": absd[at],
        "max_abs_err_at": {
            "field": names[at], "row": row,
            "row_scale": float(wr.abs().max()) if wr.numel() else 0.0},
        "ok": within(errs, bar) and all(same)})


ARENA_LEAVES = ("mean", "fac", "t_seen", "version", "phi", "q", "z", "r",
                "steady", "kgain", "fdiag", "det")


def leaves_of(arena):
    """An unsharded ``StateArena``'s leaves by name, in the order of its
    ``_dynamic``, ``_static``, ``_steady_leaves`` and ``_det_leaf``."""
    import types

    return types.SimpleNamespace(**dict(zip(ARENA_LEAVES, (
        *arena._dynamic(), *arena._static(), *arena._steady_leaves(),
        arena._det_leaf()))))


def k17_leaves(arena):
    """The leaves K17 takes ahead of the steady ones: mean, t_seen,
    version, phi and z."""
    a = leaves_of(arena)
    return a.mean, a.t_seen, a.version, a.phi, a.z


def k16_cost(body, arena, rows, mask, det):
    """Bytes and least operations of one K16 launch over the dispatched
    ``rows``: its step body's (K1, K12 or K9 from a given carry), the
    arena tail's and the integrity gate's."""
    import torch

    dev = leaves_of(arena).mean.device
    itemsize = leaves_of(arena).mean.element_size()
    idx = torch.as_tensor(rows, device=dev).long()
    z_g, q_g = leaves_of(arena).z[idx], leaves_of(arena).q[idx]
    if body == "sqrt":
        cost = k9_cost(z_g.permute(1, 2, 0), mask,
                       torch.arange(len(rows), device=dev), False, True,
                       itemsize)
    elif body == "joint":
        cost = k1_cost(z_g, q_g, mask, itemsize)
    else:
        cost = k12_cost(z_g, q_g, mask, itemsize)
    extra = arena_tail_cost(len(rows), BUCKET[0], BUCKET[1], mask.shape[1],
                            itemsize, det)
    return (cost[0] + extra[0], cost[1] + extra[1]
            + gate_cost(len(rows), BUCKET[1], body == "sqrt"))


def _arena_leaves(dtype, dev, sqrt, rng):
    """An arena of ARENA_ROWS flagship rows (bucket (24, 32)) holding
    real posteriors (ARENA_HIST steps of the rows' own data through the
    port's filter), ``t_seen`` spread across the floors, a NaN row 2 and
    (covariance) a non-PSD row 4, random detector states; returns the
    arena and each row's continuation row."""
    import numpy as np
    import torch

    from metran_tpu_torch.ops import kalman_filter, sqrt_kalman_filter
    from metran_tpu_torch.ops.statespace import StateSpace
    from metran_tpu_torch.serve.state import StateArena

    b = ARENA_ROWS + 1
    phi, q, z, r, y, mask = padded_inputs(rng, b, ARENA_HIST + 1, dtype,
                                          dev)
    ss = StateSpace(phi, q, z, r)
    yh, mh = y[:, :ARENA_HIST], mask[:, :ARENA_HIST]
    arena = StateArena(BUCKET, ARENA_ROWS, dtype=dtype, sqrt=sqrt,
                       device=dev)
    for leaf, val in zip(arena._static(), ss):
        leaf.copy_(val)
    leaves = leaves_of(arena)
    if sqrt:
        res = sqrt_kalman_filter(ss, yh, mh, store=False)
        leaves.fac.copy_(res.chol_f)
    else:
        res = kalman_filter(ss, yh, mh, engine="joint", store=False)
        leaves.fac.copy_(res.cov_f)
    leaves.mean.copy_(res.mean_f)
    leaves.t_seen.copy_(torch.as_tensor(rng.integers(0, 80, b),
                                        dtype=torch.int32))
    leaves.version.copy_(torch.as_tensor(rng.integers(0, 9, b),
                                         dtype=torch.int32))
    leaves.mean[2, 1] = float("nan")
    if not sqrt:
        leaves.fac[4] -= 50 * torch.eye(BUCKET[1], dtype=dtype, device=dev)
    arena._det_leaf().copy_(torch.as_tensor(
        np.abs(rng.normal(size=(b, 6, BUCKET[0]))), dtype=dtype))
    return arena, y[:, ARENA_HIST:], mask[:, ARENA_HIST:]


def _arena_rows(rng):
    """The dispatch: FLEET distinct rows, the NaN and non-PSD rows
    first, every third row left unnamed."""
    import numpy as np

    others = np.array([r for r in range(5, ARENA_ROWS) if r % 3])
    pick = rng.permutation(others)[:FLEET - 3]
    return np.concatenate([[3, 2, 4], pick]).astype(np.int32)


def _arena_dispatch(arena, rows, y_next, m_next, rng, k=1):
    """The dispatch's observations: each row's own continuation (k
    steps, repeated), a masked cell on every 5th row, a fully masked
    row, a 30-sd spike on the first rows."""
    import torch

    idx = torch.as_tensor(rows, device=y_next.device).long()
    y = y_next[idx].repeat(1, k, 1).contiguous()
    mask = m_next[idx].repeat(1, k, 1).contiguous()
    mask[:, :, N_SERIES:] = False
    mask[::5, 0, 3] = False
    mask[6] = False
    y[7:40, 0, 1] += GATE_SPIKE
    real = torch.zeros((len(rows), BUCKET[0]), dtype=torch.bool,
                       device=y.device)
    real[:, :N_SERIES] = True
    return y, mask, real


def phase_arena_kernels():
    """K16 (the exact arena update: gather, step body, integrity gate,
    detection tail, masked in-place scatter), K17 (the frozen-gain arena
    update) and K18 (the arena forecast) against their plain versions on
    the card at the flagship width: an arena of ARENA_ROWS = 1024 rows of
    the (24, 32) bucket, FLEET = 512 of them dispatched, k = 1; f64 and
    f32 (1e-9 / 1e-3, each row of each output and leaf against its own
    scale — :func:`row_rel_err`, so the f32 quantized spike rows, whose
    sigma reaches ~1e12, set no bar for the others — over the accepted
    rows, NaN-strict; ok, verdicts, counts, conv and applied equal).  The rows mix armed and
    unarmed models, a masked cell and a fully masked row, a NaN row and
    a non-PSD covariance row (both rejected, their rows bit-identical
    after the kernel), and unnamed rows that must stay bit-identical;
    K17 frozen rows beside broken ones.  Then each family timed at f32
    beside its bound and its plain version."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import arena as karena

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    thresh = GATE_NSIGMA ** 2
    checks, times = [], {}

    def record(*args, **kw):
        record_rows(checks, *args, **kw)

    def rows_same(leaves, ref, rows):
        idx = torch.as_tensor(rows, device=dev).long()
        return all(torch.equal(a[idx].nan_to_num(7.0),
                               b[idx].nan_to_num(7.0))
                   for a, b in zip(leaves, ref))

    def k16_args(body, mode, lik, det, tol, arena, rows, y, mask, real):
        g = len(rows)
        rob = None
        if lik is not None:
            dtype = leaves_of(arena).mean.dtype
            scale = torch.full((g, BUCKET[0]), ROBUST_SCALE, dtype=dtype,
                               device=dev)
            rob = karena.ArenaRobust(lik, 4.0, *(
                torch.full((g, BUCKET[0]), v, dtype=dtype, device=dev)
                for v in (-1.2, 1.2, 0.1)), scale)
        return dict(body=body, mode=mode, thresh=thresh, min_seen=32,
                    robust=rob, steady_tol=tol, real=real,
                    det=arena._det_leaf() if det else None, det_min_seen=16,
                    det_params=ARENA_DET)

    for dtype in (torch.float64, torch.float32):
        bar = 1e-9 if dtype == torch.float64 else 1e-3
        for body, mode, lik, det, tol in ARENA_K16_MODES:
            sqrt = body == "sqrt"
            rng = np.random.default_rng(SEED + 120)
            pair = []
            for fn in (karena.arena_update_kernel,
                       karena.arena_update_plain):
                arena, y_next, m_next = _arena_leaves(dtype, dev, sqrt, rng)
                ref = [t.clone() for t in
                       arena._dynamic() + (arena._det_leaf(),)]
                rows = _arena_rows(np.random.default_rng(SEED + 121))
                y, mask, real = _arena_dispatch(arena, rows, y_next, m_next,
                                                rng)
                out = fn(*arena._dynamic(), *arena._static(), rows, y, mask,
                         **k16_args(body, mode, lik, det, tol, arena, rows,
                                    y, mask, real))
                torch.cuda.synchronize()
                pair.append((out, arena, ref, rows))
                rng = np.random.default_rng(SEED + 120)
            (got, ka, kref, rows), (want, pa, _, _) = pair
            ok = want.ok
            name = "arena_update_sqrt" if sqrt else "arena_update"
            case = (f"{body} {mode}{' ' + lik if lik else ''}"
                    f"{' + detect' if det else ''}"
                    f"{' + conv' if tol else ''}, B={ARENA_ROWS} G={FLEET} "
                    "k=1 (24, 32)")
            fields = [f for f in ("sigma", "detf", "zscore", "iters",
                                  "det_stats")
                      if getattr(want, f) is not None]
            fk, fp = leaves_of(ka).fac, leaves_of(pa).fac
            if sqrt:
                fk, fp = fk @ fk.mT, fp @ fp.mT
            record(name, case, dtype, fields + ["mean", "F F'" if sqrt
                                                else "cov"],
                   [getattr(got, f)[ok].double() for f in fields]
                   + [leaves_of(ka).mean, fk],
                   [getattr(want, f)[ok].double() for f in fields]
                   + [leaves_of(pa).mean, fp], bar,
                   exact=[(got.ok, want.ok),
                          (leaves_of(ka).t_seen, leaves_of(pa).t_seen),
                          (leaves_of(ka).version, leaves_of(pa).version)]
                   + [(getattr(got, f), getattr(want, f))
                      for f in ("verdict", "det_counts", "conv")
                      if getattr(want, f) is not None])
            require(not bool(got.ok[1]) and (sqrt or not bool(got.ok[2])),
                    f"K16 {case}: a NaN or non-PSD row passed the gate")
            unnamed = [r for r in range(ARENA_ROWS + 1)
                       if r not in set(rows.tolist())]
            rejected = [int(rows[i]) for i in
                        torch.nonzero(~got.ok).flatten().tolist()]
            require(rows_same(ka._dynamic() + (ka._det_leaf(),), kref,
                              unnamed + rejected),
                    f"K16 {case}: a rejected or unnamed row changed")
        # K17: frozen rows beside broken ones
        for mode, seq, det in ARENA_K17_MODES:
            rng = np.random.default_rng(SEED + 122)
            pair = []
            for fn in (karena.arena_steady_update_kernel,
                       karena.arena_steady_update_plain):
                arena, y_next, m_next = _arena_leaves(dtype, dev, False, rng)
                leaves_of(arena).mean[2, 1] = 0.0
                srng = np.random.default_rng(SEED + 123)
                leaves_of(arena).steady.copy_(torch.as_tensor(
                    srng.uniform(size=ARENA_ROWS + 1) > 0.2))
                leaves_of(arena).kgain.copy_(torch.as_tensor(
                    srng.normal(size=leaves_of(arena).kgain.shape) * 0.05))
                leaves_of(arena).fdiag.copy_(torch.as_tensor(
                    srng.uniform(0.5, 2.0, leaves_of(arena).fdiag.shape)))
                ref = [t.clone() for t in
                       arena._dynamic() + (arena._det_leaf(),)]
                rows = _arena_rows(np.random.default_rng(SEED + 121))
                y, mask, real = _arena_dispatch(arena, rows, y_next, m_next,
                                                rng)
                mask[:, :, :N_SERIES] = True
                mask[::7, 0, 5] = False  # broken rows
                out = fn(*k17_leaves(arena), *arena._steady_leaves(),
                         rows, real, y, mask, mode=mode, thresh=thresh,
                         sequential=seq, min_seen=32,
                         det=arena._det_leaf() if det else None,
                         det_min_seen=16,
                         det_params=ARENA_DET)
                torch.cuda.synchronize()
                pair.append((out, arena, ref, rows))
                rng = np.random.default_rng(SEED + 122)
            (got, ka, kref, rows), (want, pa, _, _) = pair
            case = (f"{mode} {'per-slot' if seq else 'vector'}"
                    f"{' + detect' if det else ''}, B={ARENA_ROWS} "
                    f"G={FLEET} k=1 (24, 32)")
            fields = [f for f in ("sigma", "detf", "zscore", "det_stats")
                      if getattr(want, f) is not None]
            record("arena_steady_update", case, dtype, fields + ["mean"],
                   [getattr(got, f).double() for f in fields]
                   + [leaves_of(ka).mean],
                   [getattr(want, f).double() for f in fields]
                   + [leaves_of(pa).mean],
                   bar, exact=[(got.applied, want.applied),
                               (got.verdict, want.verdict),
                               (leaves_of(ka).t_seen, leaves_of(pa).t_seen),
                               (leaves_of(ka).fac, kref[1])]
                   + ([(got.det_counts, want.det_counts)] if det else []))
            require(bool(got.applied.any()) and not bool(got.applied.all()),
                    f"K17 {case}: no frozen row beside broken ones")
            unnamed = [r for r in range(ARENA_ROWS + 1)
                       if r not in set(rows.tolist())]
            skipped = [int(rows[i]) for i in
                       torch.nonzero(~got.applied).flatten().tolist()]
            require(rows_same(ka._dynamic() + (ka._det_leaf(),), kref,
                              unnamed + skipped),
                    f"K17 {case}: an unapplied or unnamed row changed")
        # K18
        for sqrt in (False, True):
            rng = np.random.default_rng(SEED + 124)
            arena, _, _ = _arena_leaves(dtype, dev, sqrt, rng)
            rows = _arena_rows(np.random.default_rng(SEED + 121))[3:]
            hz = torch.arange(1, FORECAST_STEPS + 1, device=dev).to(dtype)
            got = karena.arena_forecast_kernel(
                *arena._dynamic()[:2], *arena._static(), rows, hz, sqrt)
            want = karena.arena_forecast_plain(
                *arena._dynamic()[:2], *arena._static(), rows, hz, sqrt)
            torch.cuda.synchronize()
            record("arena_forecast", f"{'sqrt' if sqrt else 'covariance'} "
                   f"arena, G={len(rows)} H={FORECAST_STEPS}", dtype,
                   ["means", "variances"], got, want, bar)
    for c in checks:
        emit({"phase": "kernel_check", **c})
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"kernel disagrees with its plain version: {bad}")

    # the main path's shapes, f32: one dispatch of FLEET rows, k = 1
    dtype = torch.float32
    timed = {"arena_update": ("joint", "off", None, False, 1e-4),
             "arena_update_gated": ("gated", "reject", None, True, 1e-4),
             "arena_update_sqrt": ("sqrt", "off", None, False, 1e-4)}
    for key, (body, mode, lik, det, tol) in timed.items():
        sqrt = body == "sqrt"
        rng = np.random.default_rng(SEED + 125)
        arena, y_next, m_next = _arena_leaves(dtype, dev, sqrt, rng)
        rows = _arena_rows(np.random.default_rng(SEED + 121))
        y, mask, real = _arena_dispatch(arena, rows, y_next, m_next, rng)
        kw = k16_args(body, mode, lik, det, tol, arena, rows, y, mask, real)
        leaves = arena._dynamic() + arena._static()
        ms, _ = cuda_ms(lambda: karena.arena_update_kernel(
            *leaves, rows, y, mask, **kw))
        plain_ms, _ = cuda_ms(lambda: karena.arena_update_plain(
            *leaves, rows, y, mask, **kw), reps=3, warm=1)
        bms, bby = bound_ms(*k16_cost(body, arena, rows, mask, det),
                            "float32")
        times[key] = {
            "shape": f"{body} {mode}{' + detect' if det else ''} + conv, "
                     f"B={ARENA_ROWS} G={FLEET} k=1 (24, 32) f32 (one "
                     "arena update dispatch)",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": bby}
    rng = np.random.default_rng(SEED + 126)
    arena, y_next, m_next = _arena_leaves(dtype, dev, False, rng)
    leaves_of(arena).mean[2, 1] = 0.0
    leaves_of(arena).steady.fill_(True)
    srng = np.random.default_rng(SEED + 123)
    leaves_of(arena).kgain.copy_(torch.as_tensor(srng.normal(
        size=leaves_of(arena).kgain.shape) * 0.05))
    rows = _arena_rows(np.random.default_rng(SEED + 121))
    y, mask, real = _arena_dispatch(arena, rows, y_next, m_next, rng)
    mask[:, :, :N_SERIES] = True
    sargs = (*k17_leaves(arena), *arena._steady_leaves(), rows, real, y, mask)
    skw = dict(mode="reject", thresh=thresh, sequential=True, min_seen=32,
               det=arena._det_leaf(), det_min_seen=16, det_params=ARENA_DET)
    ms, _ = cuda_ms(lambda: karena.arena_steady_update_kernel(*sargs, **skw))
    plain_ms, _ = cuda_ms(lambda: karena.arena_steady_update_plain(
        *sargs, **skw), reps=3, warm=1)
    idx = torch.as_tensor(rows, device=dev).long()
    cost = k14_cost(leaves_of(arena).z[idx], leaves_of(arena).kgain[idx],
                    mask, 4)
    extra = arena_tail_cost(len(rows), BUCKET[0], BUCKET[1], 1, 4, True)
    bms, bby = bound_ms(cost[0] + extra[0], cost[1] + extra[1], "float32")
    times["arena_steady_update"] = {
        "shape": f"reject per-slot + detect, B={ARENA_ROWS} G={FLEET} k=1 "
                 "(24, 32) f32 (one steady arena dispatch)",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby}
    for sqrt in (False, True):
        rng = np.random.default_rng(SEED + 127)
        arena, _, _ = _arena_leaves(dtype, dev, sqrt, rng)
        leaves_of(arena).mean[2, 1] = 0.0
        leaves_of(arena).fac[4] += 60 * torch.eye(BUCKET[1], dtype=dtype,
                                                  device=dev)
        rows = _arena_rows(np.random.default_rng(SEED + 121))
        hz = torch.arange(1, FORECAST_STEPS + 1, device=dev).to(dtype)
        fargs = (*arena._dynamic()[:2], *arena._static(), rows, hz, sqrt)
        ms, _ = cuda_ms(lambda: karena.arena_forecast_kernel(*fargs))
        plain_ms, _ = cuda_ms(lambda: karena.arena_forecast_plain(*fargs),
                              reps=5, warm=1)
        idx = torch.as_tensor(rows, device=dev).long()
        nbytes, ops = k2_cost(leaves_of(arena).z[idx],
                              leaves_of(arena).q[idx], FORECAST_STEPS,
                              4)
        nbytes += 4 * len(rows)
        if sqrt:
            ops += len(rows) * BUCKET[1] ** 3 / 3.0
        bms, bby = bound_ms(nbytes, ops, "float32")
        times["arena_forecast" + ("_sqrt" if sqrt else "")] = {
            "shape": f"{'sqrt' if sqrt else 'covariance'} arena, "
                     f"B={ARENA_ROWS} G={FLEET} H={FORECAST_STEPS} (24, 32) "
                     "f32 (one arena forecast dispatch)",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": bby}
    emit({"phase": "arena_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "fields", "rel_err",
                           "norm", "bar", "max_abs_err_at", "ok")}
        for c in checks], "times": times,
        "seconds": time.perf_counter() - t_phase})
    return checks, times


def _fleet_states(engine, rng, t_hist, missing, poison=None, batch=FLEET,
                  npd=None):
    """The flagship fleet's posteriors after a history pass of ``t_hist``
    steps (f32 unless ``npd``; K1 or K9), as serving states of ``batch``
    models, and each model's next ARENA_STEADY_ROUNDS rows of its own
    data."""
    import numpy as np
    import torch

    from metran_tpu_torch.ops import (
        chol_outer,
        dfm_statespace,
        kalman_filter,
        sqrt_kalman_filter,
    )
    from metran_tpu_torch.serve import PosteriorState

    dev = torch.device(DEVICE)
    f32 = np.float32 if npd is None else npd
    y, mask, lds, a_s, a_c = make_workload(
        rng, batch, t=t_hist + ARENA_STEADY_ROUNDS, missing=missing)
    ss = dfm_statespace(a_s.astype(f32), a_c.astype(f32), lds.astype(f32),
                        1.0, device=dev)
    yh, mh = y[:, :t_hist].astype(f32), mask[:, :t_hist]
    if engine == "sqrt":
        res = sqrt_kalman_filter(ss, yh, mh, store=False)
        chols = res.chol_f.cpu().numpy()
        covs = chol_outer(res.chol_f).cpu().numpy()
    else:
        res = kalman_filter(ss, yh, mh, engine="joint", store=False)
        covs, chols = res.cov_f.cpu().numpy(), [None] * batch
    means = res.mean_f.cpu().numpy()
    if poison is not None:
        means[poison] = np.nan
    names = tuple(f"s{j}" for j in range(N_SERIES))
    states = [PosteriorState(
        model_id=f"m{i}", version=0, t_seen=t_hist, mean=means[i],
        cov=covs[i], params=np.concatenate([a_s[i], a_c[i]]).astype(f32),
        loadings=lds[i].astype(f32), dt=1.0,
        scaler_mean=np.zeros(N_SERIES, f32),
        scaler_std=np.ones(N_SERIES, f32), names=names, chol=chols[i])
        for i in range(batch)]
    return states, y[:, t_hist:]


def _arena_serving_run(name, engine, svc_kw, states, rows_by_round):
    """One arena serving run: a per-request arena service, a bulk
    (``update_batch``/``forecast_batch``) arena service and a dict
    service on the same states and rows, rounds paired and rotated; then
    forecasts.  A dispatch is timed from the first submit to the last
    result (``update_dispatch_ms``: the bulk call is one function), and
    the per-request services' flush alone, as the other serving phases
    time it (``update_flush_ms``).  Returns the run's summary; its
    ``launches`` are the arena services' own (launch deltas around their
    dispatches)."""
    import numpy as np

    from metran_tpu_torch.kernels import launches
    from metran_tpu_torch.serve import (
        ArenaUpdateAck,
        MetranService,
        ModelRegistry,
    )

    ids = [st.model_id for st in states]
    regs = {kind: ModelRegistry(engine=engine, arena=kind != "dict",
                                arena_rows=ARENA_ROWS, device=DEVICE)
            for kind in ("dict", "arena", "bulk")}
    for reg in regs.values():
        for st in states:
            reg.put(st, persist=False)
    svcs = {kind: MetranService(reg, flush_deadline=None, max_batch=1024,
                                persist_updates=False, device=DEVICE,
                                **svc_kw)
            for kind, reg in regs.items()}
    counts = {key: 0 for key in launches()}
    walls = {kind: [] for kind in svcs}
    flushes = {kind: [] for kind in ("dict", "arena")}
    acks = {}

    def submit_all(svc, submit, flush_walls=None):
        """One flush of a request per model; each slot's result or the
        exception it failed with (at submit: an open breaker).  The
        flush alone — what the other serving phases time — goes to
        ``flush_walls``."""
        futs = []
        for i, m in enumerate(ids):
            try:
                futs.append(submit(svc, i, m))
            except Exception as exc:  # noqa: BLE001 - per-slot channel
                futs.append(exc)
        t0 = time.perf_counter()
        svc.flush()
        if flush_walls is not None:
            flush_walls.append(time.perf_counter() - t0)
        return [f if isinstance(f, Exception) else
                (f.exception() or f.result()) for f in futs]

    def dispatch(kind, obs):
        svc = svcs[kind]
        before = launches()
        t0 = time.perf_counter()
        if kind == "bulk":
            out = svc.update_batch(ids, obs)
        else:
            out = submit_all(svc, lambda s, i, m: s.update_async(m, obs[i]),
                             flushes[kind])
        walls[kind].append(time.perf_counter() - t0)
        if kind != "dict":
            for key, v in launches().items():
                counts[key] += v - before[key]
        return out

    order = ("dict", "arena", "bulk")
    for r, obs in enumerate(rows_by_round):
        for kind in order[r % 3:] + order[:r % 3]:
            acks[kind] = dispatch(kind, obs)
        for i in range(len(ids)):
            a, b, d = acks["arena"][i], acks["bulk"][i], acks["dict"][i]
            if isinstance(d, Exception):
                require(type(a) is type(d) and isinstance(b, Exception),
                        (name, ids[i], r, repr(a), repr(b), repr(d)))
                continue
            require(isinstance(a, ArenaUpdateAck) and a == b
                    and (a.version, a.t_seen) == (d.version, d.t_seen),
                    (name, ids[i], r, a, b, d))
    fcs = {}
    for kind, svc in svcs.items():
        before = launches()
        t0 = time.perf_counter()
        if kind == "bulk":
            fcs[kind] = svc.forecast_batch(ids, FORECAST_STEPS)
        else:
            fcs[kind] = submit_all(
                svc, lambda s, i, m: s.forecast_async(m, FORECAST_STEPS))
        walls[f"forecast_{kind}"] = [time.perf_counter() - t0]
        if kind != "dict":
            for key, v in launches().items():
                counts[key] += v - before[key]
    errs = {"mean": 0.0, "cov": 0.0, "fc_means": 0.0, "fc_vars": 0.0}
    for i, mid in enumerate(ids):
        d = regs["dict"].get(mid)
        a = regs["arena"].get(mid)
        b = regs["bulk"].get(mid)
        require(a.version == b.version == d.version, (name, mid))
        if i == ARENA_POISONED:
            require(np.isnan(a.mean).all() and a.version == 0
                    and np.array_equal(a.cov, states[i].cov),
                    (name, "the poisoned row changed"))
            continue
        require(np.array_equal(a.mean, b.mean) and np.array_equal(a.cov,
                                                                  b.cov),
                (name, mid, "bulk and per-request arena differ"))
        np.testing.assert_allclose(a.mean, d.mean, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(a.cov, d.cov, rtol=2e-5, atol=1e-6)
        errs["mean"] = max(errs["mean"], float(np.abs(a.mean - d.mean).max()))
        errs["cov"] = max(errs["cov"], float(np.abs(a.cov - d.cov).max()))
        fa, fd = fcs["arena"][i], fcs["dict"][i]
        require(fa.version == fd.version == fcs["bulk"][i].version,
                (name, mid))
        np.testing.assert_allclose(fa.means, fd.means, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(fa.variances, fd.variances, rtol=2e-5,
                                   atol=1e-6)
        errs["fc_means"] = max(errs["fc_means"],
                               float(np.abs(fa.means - fd.means).max()))
        errs["fc_vars"] = max(errs["fc_vars"], float(
            np.abs(fa.variances - fd.variances).max()))
    tallies = {}
    for kind, svc in svcs.items():
        tallies[kind] = {
            "gate_verdicts": svc.gate_verdicts.snapshot(),
            "robust_total": svc.robust_total.snapshot(),
            "detect_total": svc.detect_total.snapshot(),
            "steady_transitions": svc.steady_transitions.snapshot(),
            "frozen": svc._steady_count(),
            "poisoned_updates": svc.stats.get("poisoned_updates", 0)}
        svc.close()
    # the bulk path books no breaker: the poisoned model fails every round
    # there, and until its breaker opens on the per-request paths
    poisoned = {kind: t.pop("poisoned_updates") for kind, t in
                tallies.items()}
    for kind in ("arena", "bulk"):
        require(tallies[kind] == tallies["dict"],
                (name, kind, tallies[kind], tallies["dict"]))
    require(poisoned["arena"] == poisoned["dict"] >= 1
            and poisoned["bulk"] >= poisoned["arena"],
            (name, "the poisoned model", poisoned))

    def med(xs):
        return float(np.median(xs)) * 1e3

    summary = {
        "run": name, "engine": engine, "fleet": len(ids),
        "rounds": len(rows_by_round),
        "update_dispatch_ms": {"arena": med(walls["arena"]),
                               "bulk": med(walls["bulk"]),
                               "dict": med(walls["dict"])},
        "update_dispatch_ms_by_round": {
            k: [w * 1e3 for w in walls[k]] for k in order},
        "update_flush_ms": {k: med(v) for k, v in flushes.items()},
        "forecast_dispatch_ms": {k: walls[f"forecast_{k}"][0] * 1e3
                                 for k in svcs},
        "arena_vs_dict_max_abs": errs, "tallies": tallies["arena"],
        "launches": {k: v for k, v in counts.items() if v}}
    emit({"phase": "arena_serving_run", **summary})
    return summary, counts


def _arena_evict_and_restart(all_states, all_rows):
    """A registry of ARENA_EVICT_ROWS rows taking ARENA_EVICT_MODELS
    models in batches of ARENA_EVICT_CHUNK: it must evict (spill) and reload, every
    model served again and equal to a dict twin; then ``close()`` spills
    the dirty rows and a fresh registry warm-starts from disk."""
    import shutil

    import numpy as np

    from metran_tpu_torch.serve import MetranService, ModelRegistry

    root = REPO / "chiprun_out" / "arena_spill"
    shutil.rmtree(root, ignore_errors=True)
    keep = [i for i in range(len(all_states))
            if i != ARENA_POISONED][:ARENA_EVICT_MODELS]
    sub = [all_states[i] for i in keep]
    rows = all_rows[keep]
    ids = [st.model_id for st in sub]
    reg = ModelRegistry(root=root, arena=True, arena_rows=ARENA_EVICT_ROWS,
                        device=DEVICE)
    twin = ModelRegistry(arena=False)
    for st in sub:
        reg.put(st)
        twin.put(st, persist=False)
    svc = MetranService(reg, flush_deadline=None, max_batch=1024,
                        device=DEVICE)
    tsvc = MetranService(twin, flush_deadline=None, max_batch=1024,
                         persist_updates=False, device=DEVICE)
    for r in range(3):
        for lo in range(0, ARENA_EVICT_MODELS, ARENA_EVICT_CHUNK):
            chunk = ids[lo:lo + ARENA_EVICT_CHUNK]
            for s in (svc, tsvc):
                futs = [s.update_async(m, rows[lo + j, r:r + 1])
                        for j, m in enumerate(chunk)]
                s.flush()
                for f in futs:
                    f.result()
    stats = reg.arena_stats
    require(stats["evictions"] > 0 and stats["spills"] > 0
            and stats["rows_resident"] == ARENA_EVICT_ROWS, stats)
    before = {}
    for m in ids:
        a, d = reg.get(m), twin.get(m)
        require(a.version == d.version == 3, (m, a.version, d.version))
        np.testing.assert_allclose(a.mean, d.mean, rtol=2e-5, atol=1e-6)
        before[m] = a
    svc.close()  # spills the dirty rows
    tsvc.close()
    warm = ModelRegistry(root=root, arena=True, arena_rows=ARENA_EVICT_ROWS,
                         device=DEVICE)
    for m in ids:
        back = warm.get(m)
        require(back.version == 3 and np.array_equal(back.mean,
                                                     before[m].mean)
                and np.array_equal(back.cov, before[m].cov),
                (m, "the warm restart differs from the spilled row"))
    out = {"rows": ARENA_EVICT_ROWS, "models": ARENA_EVICT_MODELS,
           **{k: stats[k] for k in ("loads", "evictions", "spills")},
           "close_spilled": len(ids), "warm_restart_equal": True}
    shutil.rmtree(root, ignore_errors=True)
    return out


def phase_arena_serving():
    """The arena serving path at the flagship width: FLEET = 512 models
    (f32) after a history pass, each run on a per-request arena service
    (``ModelRegistry(arena=True)``, arena_rows = 1024), a bulk arena
    service (``update_batch``/``forecast_batch``) and a dict service
    with the same states and traffic, rounds paired and rotated: joint
    with ``GateSpec("reject")`` and detection; sqrt ungated; joint
    robust censored with detection; steady (``SteadySpec(tol=1e-4,
    min_seen=256)``) on joint gated and on sqrt after a fully observed
    history.  One model is poisoned (NaN mean) and must fail alone, its
    row unchanged.  Acks equal across the three round by round, the
    arena's posteriors and forecasts within the f32 bars of the dict's
    (rtol 2e-5, atol 1e-6; bulk bit for bit the per-request arena), the
    booked verdicts, robust outcomes, detection and steady transitions
    equal.  Then a 64-row registry takes 96 models (eviction, spill,
    reload) and a ``close()`` spills for a warm restart.  Returns the
    arena services' launch counts and the runs' summaries."""
    import numpy as np

    from metran_tpu_torch.serve import (
        DetectSpec,
        GateSpec,
        RobustSpec,
        SteadySpec,
    )

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 130)
    gated = dict(gate=GateSpec("reject", nsigma=GATE_NSIGMA, min_seen=32),
                 detect=DetectSpec(enabled=True))
    runs, total = [], None

    def rounds(rows, n, spike=True, nan=True, clip=None):
        out = []
        for r in range(n):
            obs = np.array(rows[:, r:r + 1], dtype=float)
            if nan and r == 1:
                obs[::9, 0, 2] = np.nan
            if spike and r == 2:
                obs[10:30, 0, 4] += GATE_SPIKE
            if clip is not None:
                obs = np.clip(obs, -clip, clip)
            out.append(obs)
        return out

    def add(result):
        nonlocal total
        summary, counts = result
        runs.append(summary)
        total = counts if total is None else {
            k: total[k] + v for k, v in counts.items()}

    joint_states, joint_rows = _fleet_states(
        "joint", rng, T_STEPS, MISSING, poison=ARENA_POISONED)
    add(_arena_serving_run("joint_gated_detect", "joint", gated,
                           joint_states, rounds(joint_rows, ARENA_ROUNDS)))
    add(_arena_serving_run(
        "joint_robust_censored_detect", "joint",
        dict(robust=RobustSpec("censored", rail_lo=-1.5, rail_hi=1.5,
                               min_seen=32), detect=DetectSpec(enabled=True)),
        joint_states, rounds(joint_rows, ARENA_ROUNDS, clip=1.5)))
    sqrt_states, sqrt_rows = _fleet_states(
        "sqrt", rng, T_STEPS, MISSING, poison=ARENA_POISONED)
    add(_arena_serving_run("sqrt_ungated", "sqrt", {}, sqrt_states,
                           rounds(sqrt_rows, ARENA_ROUNDS)))
    steady = SteadySpec(tol=1e-4, min_seen=256)
    for engine, kw in (("joint", dict(gated, steady=steady)),
                       ("sqrt", dict(steady=steady))):
        st, rows = _fleet_states(engine, rng, STEADY_HIST, 0.0,
                                 poison=ARENA_POISONED)
        add(_arena_serving_run(f"steady_{engine}", engine, kw, st,
                               rounds(rows, ARENA_STEADY_ROUNDS, spike=False,
                                      nan=False)))
        require(runs[-1]["tallies"]["steady_transitions"].get("freeze", 0)
                >= FLEET // 2, (engine, "the steady run froze too few"))
    evict = _arena_evict_and_restart(joint_states, joint_rows)
    for key in ("arena_update", "arena_update_sqrt", "arena_steady_update",
                "arena_forecast"):
        require(total[key] > 0, f"the arena path never launched {key}")
    emit({"phase": "arena_serving", "runs": [
        {k: r[k] for k in ("run", "update_dispatch_ms", "update_flush_ms",
                           "forecast_dispatch_ms", "launches")}
        for r in runs], "evict_restart": evict,
        "launches": {k: v for k, v in total.items() if v},
        "seconds": time.perf_counter() - t_phase})
    return total, runs


READPATH_HORIZONS = "1-30"  # the service's default set (SERVE_HORIZONS)
READPATH_SETS = ("1-30", "1,7,30")  # contiguous, and values that are not
#                                     1..H (the kernels read h as a value)
# K16 horizons checks: (body, mode, robust likelihood, detection, steady_tol)
READPATH_K16_MODES = (
    ("joint", "off", None, False, 1e-4),
    ("gated", "reject", None, True, 1e-4),
    ("gated", "off", "censored", True, 0.0),
    ("sqrt", "off", None, False, 1e-4),
    ("sqrt", "reject", None, True, 0.0),
)
READPATH_K17_MODES = (("off", False, False), ("reject", True, True))
READPATH_K14_FORMS = (("off", False), ("reject", True))
READPATH_ROUNDS = 6  # paired update rounds of the f32 read-path run
READPATH_REPS = 5  # paired forecast repetitions, hit against compute
READPATH_F64 = 64  # models of the f64 runs (sqrt arena; frozen rows)
READPATH_F64_ROUNDS = 4  # their update rounds (tests/test_steady.py:393)


def horizon_cost(z, q, h, itemsize, means_only, sqrt=False):
    """Bytes and least operations a horizons tail adds to its update
    launch over the rows of ``z`` (G, N, S): the (G, H, N) means (and
    variances) written once; per (row, horizon) the means' ``phi^h o m``
    and ``Z m_h`` on Z's nonzeros, and the variances' K2 operations
    (:func:`k2_cost`; its input bytes are the update's own) with, on a
    factor row, ``F F'`` (S^3 / 3, as K18's bound counts it)."""
    g, n, s = z.shape
    nbytes = (1 if means_only else 2) * g * h * n * itemsize
    if means_only:
        nnz = float((z != 0).double().sum())
        return nbytes, h * (2.0 * g * s + 2.0 * nnz)
    ops = k2_cost(z, q, h, itemsize)[1]
    if sqrt:
        ops += g * s ** 3 / 3.0
    return nbytes, ops


def phase_readpath_kernels():
    """The read path's kernels (B13's commit-time horizon pass): the
    ``horizons`` modes of K16, K17 and K14 against their plain versions
    on the card at the flagship width — an arena of ARENA_ROWS rows of
    the (24, 32) bucket, FLEET of them dispatched, k = 1 (K14: FLEET
    models) — f64 and f32 (1e-9 / 1e-3, every row of the forecast means
    and variances against its own scale, NaN-strict: the rejected NaN
    row's moments are its prior's), at the horizon sets "1-30" and
    "1,7,30".  Then the contract the read path rests on: every K16 and
    K17 snapshot equals K18's read of the written arena bit for bit at
    f64 (f32 reported).  Then each mode timed at f32, H = 30, beside the
    same launch without it (alternating, in this call), its bound and
    its plain version."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import arena as karena
    from metran_tpu_torch.kernels import steady_filter, steady_filter_plain
    from metran_tpu_torch.serve.readpath import parse_horizons

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    thresh = GATE_NSIGMA ** 2
    checks, times, vs_k18 = [], {}, []

    def hset(spec, dtype):
        return torch.tensor(parse_horizons(spec), dtype=dtype, device=dev)

    def k16_kw(body, mode, lik, det, tol, arena, rows, real, hz):
        rob = None
        if lik is not None:
            rob = karena.ArenaRobust(lik, 4.0, *(
                torch.full((len(rows), BUCKET[0]), v,
                           dtype=leaves_of(arena).mean.dtype, device=dev)
                for v in (-1.2, 1.2, 0.1, ROBUST_SCALE)))
        return dict(body=body, mode=mode, thresh=thresh, min_seen=32,
                    robust=rob, steady_tol=tol, real=real,
                    det=arena._det_leaf() if det else None, det_min_seen=16,
                    det_params=ARENA_DET, horizons=hz)

    def k16_run(fn, dtype, body, mode, lik, det, tol, hz):
        rng = np.random.default_rng(SEED + 140)
        arena, y_next, m_next = _arena_leaves(dtype, dev, body == "sqrt",
                                              rng)
        rows = _arena_rows(np.random.default_rng(SEED + 121))
        y, mask, real = _arena_dispatch(arena, rows, y_next, m_next, rng)
        out = fn(*arena._dynamic(), *arena._static(), rows, y, mask,
                 **k16_kw(body, mode, lik, det, tol, arena, rows, real, hz))
        torch.cuda.synchronize()
        return out, arena, rows, mask

    def steady_arena(dtype):
        rng = np.random.default_rng(SEED + 141)
        arena, y_next, m_next = _arena_leaves(dtype, dev, False, rng)
        leaves_of(arena).mean[2, 1] = 0.0
        srng = np.random.default_rng(SEED + 123)
        leaves_of(arena).steady.copy_(torch.as_tensor(
            srng.uniform(size=ARENA_ROWS + 1) > 0.2))
        leaves_of(arena).kgain.copy_(torch.as_tensor(
            srng.normal(size=leaves_of(arena).kgain.shape) * 0.05))
        leaves_of(arena).fdiag.copy_(torch.as_tensor(
            srng.uniform(0.5, 2.0, leaves_of(arena).fdiag.shape)))
        rows = _arena_rows(np.random.default_rng(SEED + 121))
        y, mask, real = _arena_dispatch(arena, rows, y_next, m_next, rng)
        mask[:, :, :N_SERIES] = True
        mask[::7, 0, 5] = False  # broken rows
        return arena, rows, y, mask, real

    def against_k18(kernel, case, dtype, arena, rows, hz, sqrt, fm, fv):
        """The snapshot against K18's read of the arena as written."""
        km, kv = karena.arena_forecast_kernel(
            *arena._dynamic()[:2], *arena._static(), rows, hz, sqrt)
        torch.cuda.synchronize()
        pairs = [(fm, km)] + ([(fv, kv)] if fv is not None else [])
        vs_k18.append({
            "kernel": kernel, "case": case, "dtype": str(dtype)[6:],
            "bitwise": all(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
                           for a, b in pairs),
            "max_abs_err": max(abs_err(a, b) for a, b in pairs)})

    for dtype in (torch.float64, torch.float32):
        bar = 1e-9 if dtype == torch.float64 else 1e-3
        for spec in READPATH_SETS:
            hz = hset(spec, dtype)
            for body, mode, lik, det, tol in READPATH_K16_MODES:
                sqrt = body == "sqrt"
                got, ka, rows, _ = k16_run(karena.arena_update_kernel, dtype,
                                           body, mode, lik, det, tol, hz)
                want = k16_run(karena.arena_update_plain, dtype, body, mode,
                               lik, det, tol, hz)[0]
                name = "arena_update_sqrt" if sqrt else "arena_update"
                case = (f"horizons {spec}: {body} {mode}"
                        f"{' ' + lik if lik else ''}"
                        f"{' + detect' if det else ''}"
                        f"{' + conv' if tol else ''}, B={ARENA_ROWS} "
                        f"G={FLEET} k=1 (24, 32)")
                record_rows(checks, name, case, dtype, ["fmeans", "fvars"],
                            [got.fmeans, got.fvars],
                            [want.fmeans, want.fvars], bar,
                            exact=[(got.ok, want.ok)])
                require(not bool(got.ok[1]),
                        f"K16 {case}: the NaN row passed the gate")
                against_k18(name, case, dtype, ka, rows, hz, sqrt,
                            got.fmeans, got.fvars)
            for mode, seq, det in READPATH_K17_MODES:
                outs = []
                for fn in (karena.arena_steady_update_kernel,
                           karena.arena_steady_update_plain):
                    arena, rows, y, mask, real = steady_arena(dtype)
                    outs.append((fn(
                        *k17_leaves(arena), *arena._steady_leaves(), rows,
                        real, y, mask, mode=mode, thresh=thresh,
                        sequential=seq, min_seen=32,
                        det=arena._det_leaf() if det else None,
                        det_min_seen=16,
                        det_params=ARENA_DET, horizons=hz), arena))
                    torch.cuda.synchronize()
                (got, ka), (want, _) = outs
                case = (f"horizons {spec}: {mode} "
                        f"{'per-slot' if seq else 'vector'}"
                        f"{' + detect' if det else ''}, B={ARENA_ROWS} "
                        f"G={FLEET} k=1 (24, 32)")
                record_rows(checks, "arena_steady_update", case, dtype,
                            ["fmeans"], [got.fmeans], [want.fmeans], bar,
                            exact=[(got.applied, want.applied)])
                require(bool(got.applied.any())
                        and not bool(got.applied.all()),
                        f"K17 {case}: no frozen row beside broken ones")
                against_k18("arena_steady_update", case, dtype, ka, rows,
                            hz, False, got.fmeans, None)
            for policy, seq in READPATH_K14_FORMS:
                phi, z, gains, real, mean, y, mask, armed = \
                    _steady_bucket_case(np.random.default_rng(SEED + 142),
                                        dtype, dev)
                kg, fd = (gains[2], gains[3]) if seq else (gains[0], gains[1])
                args = (phi, z, kg, fd, real, mean, y, mask, armed, policy,
                        thresh, seq)
                got = steady_filter(*args, horizons=hz)
                want = steady_filter_plain(*args, horizons=hz)
                torch.cuda.synchronize()
                record_rows(
                    checks, "steady_filter",
                    f"horizons {spec}: {policy} "
                    f"{'per-slot' if seq else 'vector'}, B={FLEET} k=1 "
                    "(24, 32)", dtype, ["fmeans", "mean"],
                    [got[6], got[0]], [want[6], want[0]], bar,
                    exact=[(got[3], want[3])])
    for c in checks:
        emit({"phase": "kernel_check", **c})
    emit({"phase": "readpath_vs_k18", "checks": vs_k18})
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"kernel disagrees with its plain version: {bad}")
    bad = [c for c in vs_k18 if c["dtype"] == "float64" and not c["bitwise"]]
    require(not bad, f"a snapshot differs from K18's read at f64: {bad}")

    # the main path's shapes, f32, H = 30: each mode beside the same
    # launch without it, alternating (off, on, on, off)
    dtype = torch.float32
    hz = hset(READPATH_HORIZONS, dtype)
    h = hz.shape[0]

    def paired(fn_off, fn_on):
        a, _ = cuda_ms(fn_off)
        b, _ = cuda_ms(fn_on)
        c, _ = cuda_ms(fn_on)
        d, _ = cuda_ms(fn_off)
        return (b + c) / 2.0, (a + d) / 2.0

    timed = {"arena_update_horizons": ("joint", "off", None, False, 1e-4),
             "arena_update_gated_horizons": ("gated", "reject", None, True,
                                             1e-4),
             "arena_update_sqrt_horizons": ("sqrt", "off", None, False,
                                            1e-4)}
    for key, (body, mode, lik, det, tol) in timed.items():
        sqrt = body == "sqrt"
        rng = np.random.default_rng(SEED + 143)
        arena, y_next, m_next = _arena_leaves(dtype, dev, sqrt, rng)
        rows = _arena_rows(np.random.default_rng(SEED + 121))
        y, mask, real = _arena_dispatch(arena, rows, y_next, m_next, rng)
        kw = k16_kw(body, mode, lik, det, tol, arena, rows, real, hz)
        off = dict(kw, horizons=None)
        leaves = arena._dynamic() + arena._static()
        ms, ms_off = paired(
            lambda: karena.arena_update_kernel(*leaves, rows, y, mask, **off),
            lambda: karena.arena_update_kernel(*leaves, rows, y, mask, **kw))
        plain_ms, _ = cuda_ms(lambda: karena.arena_update_plain(
            *leaves, rows, y, mask, **kw), reps=3, warm=1)
        idx = torch.as_tensor(rows, device=dev).long()
        base = k16_cost(body, arena, rows, mask, det)
        tail = horizon_cost(leaves_of(arena).z[idx], leaves_of(arena).q[idx],
                            h, 4, False, sqrt)
        bms, bby = bound_ms(base[0] + tail[0], base[1] + tail[1], "float32")
        tbms, tbby = bound_ms(*tail, "float32")
        times[key] = {
            "shape": f"{body} {mode}{' + detect' if det else ''} + conv + "
                     f"horizons 1-30, B={ARENA_ROWS} G={FLEET} k=1 (24, 32) "
                     "f32 (one arena update dispatch)",
            "ms": ms, "ms_without_horizons": ms_off,
            "horizons_added_ms": ms - ms_off, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bby, "horizons_bound_ms": tbms,
            "horizons_bound_by": tbby}
    arena, rows, y, mask, real = steady_arena(dtype)
    leaves_of(arena).steady.fill_(True)
    mask[:, :, :N_SERIES] = True
    sargs = (*k17_leaves(arena), *arena._steady_leaves(), rows, real, y, mask)
    skw = dict(mode="reject", thresh=thresh, sequential=True, min_seen=32,
               det=arena._det_leaf(), det_min_seen=16, det_params=ARENA_DET,
               horizons=hz)
    ms, ms_off = paired(
        lambda: karena.arena_steady_update_kernel(
            *sargs, **dict(skw, horizons=None)),
        lambda: karena.arena_steady_update_kernel(*sargs, **skw))
    plain_ms, _ = cuda_ms(lambda: karena.arena_steady_update_plain(
        *sargs, **skw), reps=3, warm=1)
    idx = torch.as_tensor(rows, device=dev).long()
    base = k14_cost(leaves_of(arena).z[idx], leaves_of(arena).kgain[idx],
                    mask, 4)
    extra = arena_tail_cost(len(rows), BUCKET[0], BUCKET[1], 1, 4, True)
    tail = horizon_cost(leaves_of(arena).z[idx], None, h, 4, True)
    bms, bby = bound_ms(base[0] + extra[0] + tail[0],
                        base[1] + extra[1] + tail[1], "float32")
    times["arena_steady_update_horizons"] = {
        "shape": f"reject per-slot + detect + horizons 1-30, B={ARENA_ROWS} "
                 f"G={FLEET} k=1 (24, 32) f32 (one steady arena dispatch)",
        "ms": ms, "ms_without_horizons": ms_off,
        "horizons_added_ms": ms - ms_off, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": bby}
    phi, z, gains, real, mean, y, mask, armed = _steady_bucket_case(
        np.random.default_rng(SEED + 144), dtype, dev)
    args = (phi, z, gains[2], gains[3], real, mean, y, mask, armed,
            "reject", thresh, True)
    ms, ms_off = paired(lambda: steady_filter(*args),
                        lambda: steady_filter(*args, horizons=hz))
    plain_ms, _ = cuda_ms(lambda: steady_filter_plain(*args, horizons=hz),
                          reps=3, warm=1)
    base = k14_cost(z, gains[2], mask, 4)
    tail = horizon_cost(z, None, h, 4, True)
    bms, bby = bound_ms(base[0] + tail[0], base[1] + tail[1], "float32")
    times["steady_filter_horizons"] = {
        "shape": f"reject per-slot + horizons 1-30, B={FLEET} k=1 (24, 32) "
                 "f32 (one dict steady dispatch)",
        "ms": ms, "ms_without_horizons": ms_off,
        "horizons_added_ms": ms - ms_off, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": bby}
    emit({"phase": "readpath_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "fields", "rel_err",
                           "norm", "bar", "max_abs_err_at", "ok")}
        for c in checks], "times": times,
        "seconds": time.perf_counter() - t_phase})
    return checks, times


def phase_readpath():
    """The materialized read path (ROADMAP A4.5) on the flagship fleet:
    FLEET = 512 models of the (24, 32) bucket after a history pass (f32,
    joint), horizons "1-30" (the JAX default), on four services with the
    same states and traffic — an arena registry with the read path and
    one without (bulk ``update_batch``), a dict registry with it and one
    without (per request) — READPATH_ROUNDS update rounds paired and
    rotated; equal acks.  Then: a warm ``forecast_batch`` of all 512
    models launches no kernel (the launch counters' delta) on either
    read-path service; each hit equals the compute path (K18 on the
    arena, K2 on the dict registry; f32 within rtol 2e-5 / atol 1e-6,
    bit-identical counted); the 512-request forecast timed hit against
    compute, per request and in bulk, rotated pairs.  Then f64: a
    square-root arena of READPATH_F64 models whose hits equal K18's
    compute path bit for bit, and frozen rows (``SteadySpec(tol=1e-9)``,
    arena K17 and dict K14) whose hits agree with the exact twins'
    compute path within 1e-8 (``tests/test_steady.py:393``) and whose
    means equal their own compute path bit for bit.  Returns the
    read-path services' launch counts (their dispatches and forecasts)."""
    import numpy as np

    from metran_tpu_torch.kernels import launches
    from metran_tpu_torch.serve import (
        ArenaUpdateAck,
        MetranService,
        ModelRegistry,
        SteadySpec,
    )

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 150)
    counts = {key: 0 for key in launches()}

    def counted(fn):
        before = launches()
        out = fn()
        for key, v in launches().items():
            counts[key] += v - before[key]
        return out

    def services(engine, states, kinds, **kw):
        out = {}
        for kind in kinds:
            reg = ModelRegistry(engine=engine, arena=kind.startswith("arena"),
                                arena_rows=ARENA_ROWS, device=DEVICE)
            for st in states:
                reg.put(st, persist=False)
            rp = kind.endswith("_rp")
            out[kind] = MetranService(
                reg, flush_deadline=None, max_batch=4096,
                persist_updates=False, device=DEVICE, readpath=rp,
                horizons=READPATH_HORIZONS, **(kw if rp else {}))
        return out

    def update(svc, ids, obs):
        if svc.registry.arena_enabled:
            return svc.update_batch(ids, obs)
        futs = [svc.update_async(m, obs[i]) for i, m in enumerate(ids)]
        svc.flush()
        return [f.result() for f in futs]

    def per_request(svc, ids, steps):
        futs = [svc.forecast_async(m, steps) for m in ids]
        svc.flush()
        return [f.result() for f in futs]

    def compute(svc, ids, steps):
        """The compute path of a read-path service, past its cache."""
        return svc._forecast_batch_compute(ids, steps)

    def ms(t0):
        return (time.perf_counter() - t0) * 1e3

    # f32, joint, 512 models
    states, rows = _fleet_states("joint", rng, T_STEPS, MISSING)
    ids = [st.model_id for st in states]
    svcs = services("joint", states, ("arena_rp", "arena", "dict_rp",
                                      "dict"))
    order = tuple(svcs)
    walls = {k: [] for k in order}
    for r in range(READPATH_ROUNDS):
        obs = np.array(rows[:, r:r + 1], dtype=float)
        acks = {}
        for kind in order[r % 4:] + order[:r % 4]:
            svc = svcs[kind]
            t0 = time.perf_counter()
            if kind.endswith("_rp"):
                acks[kind] = counted(lambda: update(svc, ids, obs))
            else:
                acks[kind] = update(svc, ids, obs)
            walls[kind].append(ms(t0))
        for i in range(len(ids)):
            a, d = acks["arena_rp"][i], acks["dict_rp"][i]
            require(isinstance(a, ArenaUpdateAck) and a == acks["arena"][i]
                    and (a.version, a.t_seen) == (d.version, d.t_seen)
                    == (acks["dict"][i].version, acks["dict"][i].t_seen),
                    ("readpath acks", ids[i], r, a, d))
    steps = FORECAST_STEPS
    warm_launches, bitwise = {}, {}
    for kind in ("arena_rp", "dict_rp"):
        svc = svcs[kind]
        h0 = svc.readpath.hits
        before = launches()
        warm = svc.forecast_batch(ids, steps)
        delta = {k: v - before[k] for k, v in launches().items()
                 if v != before[k]}
        require(not delta and svc.readpath.hits - h0 == len(ids),
                (kind, "a warm forecast_batch launched", delta))
        warm_launches[kind] = delta
        want = counted(lambda: compute(svc, ids, steps))
        twin = svcs[kind[:-3]].forecast_batch(ids, steps)
        same = 0
        for w, c, t in zip(warm, want, twin):
            require(w.version == c.version == t.version,
                    (kind, w.version, c.version, t.version))
            for ref in (c, t):
                np.testing.assert_allclose(w.means, ref.means, rtol=2e-5,
                                           atol=1e-6)
                np.testing.assert_allclose(w.variances, ref.variances,
                                           rtol=2e-5, atol=1e-6)
            same += bool(np.array_equal(w.means, c.means)
                         and np.array_equal(w.variances, c.variances))
        bitwise[kind] = same
    fc = {k: [] for k in ("arena_bulk_hit", "arena_bulk_compute",
                          "arena_request_hit", "arena_request_compute",
                          "dict_request_hit", "dict_request_compute")}
    jobs = (("arena_bulk_hit", lambda: svcs["arena_rp"].forecast_batch(
                ids, steps)),
            ("arena_bulk_compute", lambda: svcs["arena"].forecast_batch(
                ids, steps)),
            ("arena_request_hit", lambda: per_request(svcs["arena_rp"], ids,
                                                      steps)),
            ("arena_request_compute", lambda: per_request(svcs["arena"], ids,
                                                          steps)),
            ("dict_request_hit", lambda: per_request(svcs["dict_rp"], ids,
                                                     steps)),
            ("dict_request_compute", lambda: per_request(svcs["dict"], ids,
                                                         steps)))
    for r in range(READPATH_REPS):
        for key, job in jobs[r % len(jobs):] + jobs[:r % len(jobs)]:
            t0 = time.perf_counter()
            if key.endswith("_hit"):
                counted(job)
            else:
                job()
            fc[key].append(ms(t0))
    require(all(svcs[k].readpath.stale == 0 for k in ("arena_rp",
                                                      "dict_rp")),
            "a read-path entry went stale without an external put")
    stats = {k: svcs[k].readpath.stats() for k in ("arena_rp", "dict_rp")}
    for svc in svcs.values():
        svc.close()

    def med(xs):
        return float(np.median(xs))

    # f64: a square-root arena (K16's factor rows), bit for bit
    states, rows = _fleet_states("sqrt", rng, ARENA_HIST, MISSING,
                                 batch=READPATH_F64, npd=np.float64)
    ids64 = [st.model_id for st in states]
    svcs = services("sqrt", states, ("arena_rp", "arena"))
    for r in range(READPATH_F64_ROUNDS):
        obs = np.array(rows[:, r:r + 1], dtype=float)
        counted(lambda: update(svcs["arena_rp"], ids64, obs))
        update(svcs["arena"], ids64, obs)
    hits = svcs["arena_rp"].forecast_batch(ids64, steps)
    own = counted(lambda: compute(svcs["arena_rp"], ids64, steps))
    twin = svcs["arena"].forecast_batch(ids64, steps)
    for w, c, t in zip(hits, own, twin):
        require(w.version == c.version == t.version
                and all(np.array_equal(getattr(w, f), getattr(ref, f))
                        for f in ("means", "variances") for ref in (c, t)),
                ("f64 sqrt arena: a hit differs from the compute path",
                 w.version))
    for svc in svcs.values():
        svc.close()

    # f64 frozen rows: K17 (arena) and K14 (dict) with their cached
    # variances, against exact twins
    states, rows = _fleet_states("joint", rng, STEADY_HIST, 0.0,
                                 batch=READPATH_F64, npd=np.float64)
    steady = SteadySpec(tol=STEADY_TOL["float64"], min_seen=STEADY_MIN_SEEN)
    svcs = services("joint", states, ("arena_rp", "arena", "dict_rp",
                                      "dict"), steady=steady)
    for r in range(READPATH_F64_ROUNDS):
        obs = np.array(rows[:, r:r + 1], dtype=float)
        for kind, svc in svcs.items():
            if kind.endswith("_rp"):
                counted(lambda: update(svc, ids64, obs))
            else:
                update(svc, ids64, obs)
    frozen_dev = {}
    for kind in ("arena_rp", "dict_rp"):
        svc = svcs[kind]
        require(svc._steady_count() == READPATH_F64,
                (kind, "froze", svc._steady_count()))
        hits = svc.forecast_batch(ids64, steps)
        own = counted(lambda: compute(svc, ids64, steps))
        twin = svcs[kind[:-3]].forecast_batch(ids64, steps)
        dev_max = 0.0
        for w, c, t in zip(hits, own, twin):
            require(w.version == c.version == t.version
                    and np.array_equal(w.means, c.means),
                    (kind, "a frozen hit's means differ from its own "
                     "compute path"))
            dev_max = max(dev_max, float(np.abs(w.means - t.means).max()),
                          float(np.abs(w.variances - t.variances).max()))
        require(dev_max < STEADY_DEV["float64"],
                (kind, "frozen hits vs the exact twin", dev_max))
        frozen_dev[kind] = dev_max
    for svc in svcs.values():
        svc.close()
    for key in ("arena_update", "arena_update_sqrt", "arena_steady_update",
                "steady_filter", "forecast_moments"):
        require(counts[key] > 0, f"the read path never launched {key}")
    emit({"phase": "readpath",
          "fleet": FLEET, "horizons": READPATH_HORIZONS,
          "forecast_steps": steps,
          "update_dispatch_ms": {k: med(v) for k, v in walls.items()},
          "update_dispatch_ms_by_round": walls,
          "forecast_512_ms": {k: med(v) for k, v in fc.items()},
          "forecast_512_ms_by_rep": fc,
          "warm_forecast_batch_launches": warm_launches,
          "hits_bitwise_own_compute_f32": bitwise, "cache": stats,
          "frozen_vs_exact_max_abs": frozen_dev,
          "launches": {k: v for k, v in counts.items() if v},
          "seconds": time.perf_counter() - t_phase})
    return counts


# ----------------------------------------------------------------------
# slice 12: the associative-scan engines (K19-K22) and their paths
# ----------------------------------------------------------------------
PK_MODELS = 16  # flagship models of the kernel-vs-plain comparison
PK_T_CMP = 400  # its steps
PK_CHUNK = 64  # its chunk length: 6 chunks and a ragged 16-step tail
PK_LONG = (8, 1, 32_768)  # examples/long_context_example.py:55 (n, k, T)
PK_FLEET_HOLD = 250  # steps of the fleet launches' plain hold (one chunk a
#                      model: the plain scan is 5,000 serial steps)
PK_NAMES = ("parallel_filter", "parallel_smooth", "sqrt_parallel_filter",
            "sqrt_parallel_smooth")


def _tria_ops(rows, n):
    """The QR of a dense ``rows`` x ``n`` stack (``rows`` >= ``n``)."""
    return sum(_house_ops(rows - 1 - j, n - 1 - j) for j in range(n))


def _pk_step_ops(kind, n, o):
    """Operations of one step's element, full combine, reduced combine and
    tails (``kind`` "cov"/"sqrt" filter, "cov_s"/"sqrt_s" smoother) with
    ``o`` observed slots; products counted dense (2 flops per
    multiply-add), factorizations at their textbook counts, QRs by
    :func:`_house_ops` over the rows a reflector must touch."""
    n2, n3 = n * n, n**3
    if kind == "cov":
        elem = (2 * o * n2 + 2 * o * o * n + o**3 / 3
                + 2 * o * o * (2 * n + 1) + 4 * n2 * o + 4 * o * n + 2 * n3)
        full = 14 * n3 + 4 * n3 / 3 + 2 * n2 * (3 * n + 2) + 10 * n2
        red = 6 * n3 + 2 * n3 / 3 + 2 * n2 * (n + 1) + 4 * n2
        tails = 2 * n2 + 2 * o * n2 + 2 * o * o * n + 2 * o * n + o**3 / 3 \
            + o * o + 3 * o
    elif kind == "sqrt":
        qr = (sum(_house_ops(n, o + n - 1 - c) for c in range(o))
              + sum(_house_ops(n - 1 - j, n - 1 - j) for j in range(n)))
        elem = qr + o * o * (n + 1) + 4 * n2 * o + 4 * o * n
        tria = _tria_ops(2 * n, n)
        full = 24 * n3 + n3 / 3 + 2 * n2 * (2 * n + 2) + 14 * n2 + tria
        red = 7 * n3 + n3 / 3 + 8 * n2 + tria
        tails = (sum(_house_ops(j + 1, n - 1 - j) for j in range(n))
                 + o * n2 + (_tria_ops(n + o, o) if o else 0) + 2 * o * n
                 + o * o + 3 * o)
    elif kind == "cov_s":
        elem = n3 / 3 + 6 * n3 + 2 * n2
        full, red, tails = 6 * n3 + 2 * n2, 4 * n3 + 2 * n2, 0
    else:  # sqrt_s
        tria = _tria_ops(2 * n, n)
        elem = 5 * n3 + 3 * n2 + tria
        full, red, tails = 4 * n3 + 2 * n2 + tria, 2 * n3 + 2 * n2 + tria, 0
    return elem, full, red, tails


def pk_cost(kind, batch, t_steps, big_n, n, chunk, obs, itemsize):
    """Bytes K19-K22 must move (the model and data, or the stored filter,
    read once; the per-step outputs written once) and the operations of
    this run's decomposition: every step's element and tails once, the
    up-sweep's full combines over all chunks but the last, the carry's and
    the down-sweep's reduced combines; ``obs`` (B, T) the observed count
    of each step (a filter's elements and tails scale with it).  The
    kernels form each up-swept step's element a second time in the
    down-sweep; that is their choice, not the function's work, and is not
    counted."""
    import collections

    c = -(-t_steps // chunk)
    if kind in ("cov", "sqrt"):
        q_el = n * n if kind == "cov" else n
        nbytes = (batch * (n + q_el + big_n * n + big_n) * itemsize
                  + batch * t_steps * big_n * (itemsize + 1)
                  + batch * t_steps * (2 * n + 2 * n * n + 2) * itemsize)
        counts = collections.Counter(obs.flatten().tolist())
        per_step = sum(cnt * (_pk_step_ops(kind, n, o)[0]
                              + _pk_step_ops(kind, n, o)[3])
                       for o, cnt in counts.items())
    else:
        q_el = 0 if kind == "cov_s" else n
        nbytes = (batch * (n + q_el) * itemsize
                  + batch * t_steps * (3 * n + 3 * n * n) * itemsize)
        per_step = batch * t_steps * _pk_step_ops(kind, n, 0)[0]
    _, full, red, _ = _pk_step_ops(kind, n, 0)
    ops = (per_step + batch * (c - 1) * (chunk - 1) * full
           + batch * (max(c - 2, 0) + t_steps - 1) * red)
    return nbytes, ops


def _pk_case(rng, batch, t, dtype, dev, shape=(N_SERIES, N_FACTORS),
             stress=False):
    """``(phi, q, z, r, y, mask)`` batch-major from the flagship recipe (or
    ``shape`` = (series, factors)); ``stress`` masks two whole steps and
    gives the last model an observed slot with r < 0."""
    import numpy as np
    import torch

    from metran_tpu_torch.ops import dfm_statespace

    n_obs, k = shape
    y, mask, lds, a_s, a_c = make_workload(rng, batch, n=n_obs, k=k, t=t)
    if stress:
        mask[:, 50:52] = False
        mask[-1, 60:, 3] = True
    ss = dfm_statespace(a_s, a_c, lds, np.ones(batch), device=dev,
                        dtype=dtype)
    r = ss.r.clone()
    if stress:
        r[-1, 3] = -2.0
    new = dict(dtype=dtype, device=dev)
    return (ss.phi.contiguous(), ss.q.contiguous(), ss.z.contiguous(),
            r.contiguous(), torch.as_tensor(y, **new),
            torch.as_tensor(mask, device=dev))


def _pk_outputs(name, out):
    """Outputs as compared: square-root factors (the square matrices; no
    mean is square at these T) through ``S S'``."""
    from metran_tpu_torch.ops import chol_outer

    if not name.startswith("sqrt"):
        return list(out)
    return [chol_outer(o) if o.dim() >= 3 and o.shape[-1] == o.shape[-2]
            else o for o in out]


def phase_pkalman_kernels():
    """K19-K22 (the associative-scan filter and smoother, covariance and
    square-root) against their plain versions on the card on the same
    chunks, f64 (1e-9) and f32 (1e-3), NaN- and inf-strict, factors
    through S S': PK_MODELS flagship models over PK_T_CMP steps in chunks
    of PK_CHUNK (a ragged tail), two all-missing steps, the last model
    observing a slot with r < 0 (its terms +inf on both sides), with and
    without the stored moments.  Then each kernel timed in f32 beside its
    sequential twin on the same inputs (K1 ``store`` + K8 for the
    covariance pair, K9 ``store`` + K10 for the square-root pair) at (a)
    one flagship model, (b) FLEET flagship models, (c) the long-context
    model (8 series, 1 factor, T = 32,768), each at the automatic chunk
    length; each timed launch's outputs are held to the plain version run
    on the card on the same inputs and chunks (the first PK_MODELS models
    of the fleet, over the filters' first and the smoothers' last
    PK_FLEET_HOLD steps), at the f32 bar."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import pkalman as kpk
    from metran_tpu_torch.kernels.joint_filter import joint_filter_store
    from metran_tpu_torch.kernels.smoother import rts_smooth
    from metran_tpu_torch.kernels.sqrt_filter import sqrt_filter
    from metran_tpu_torch.kernels.sqrt_smoother import sqrt_smooth

    dev = torch.device(DEVICE)
    checks = []

    def pair(name, got, want, dtype, bar, case):
        checks.append(check_entry(name, case, dtype, _pk_outputs(name, got),
                                  _pk_outputs(name, want), bar))

    for dtype, bar in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        phi, q, z, r, y, mask = _pk_case(np.random.default_rng(SEED + 120),
                                         PK_MODELS, PK_T_CMP, dtype, dev,
                                         stress=True)
        qd = torch.diagonal(q, 0, -2, -1).contiguous()
        case = (f"{PK_MODELS} flagship models, T={PK_T_CMP}, chunk "
                f"{PK_CHUNK}, masked steps, r < 0 in the last")
        for sqrt in (False, True):
            fname = "sqrt_parallel_filter" if sqrt else "parallel_filter"
            fk = kpk.sqrt_parallel_filter if sqrt else kpk.parallel_filter
            fp = (kpk.sqrt_parallel_filter_plain if sqrt
                  else kpk.parallel_filter_plain)
            qq = qd if sqrt else q
            for store in (True, False):
                got = fk(phi, qq, z, r, y, mask, PK_CHUNK, store)
                want = fp(phi, qq, z, r, y, mask, PK_CHUNK, store)
                torch.cuda.synchronize()
                pair(fname, got, want, dtype, bar,
                     f"{case}, {'store' if store else 'terms only'}")
                require(bool(torch.isinf(got[-1][-1]).any())
                        and bool(torch.isinf(want[-1][-1]).any()),
                        f"{fname}: the r < 0 model booked no +inf")
                require(bool(torch.isfinite(got[-1][:-1]).all()),
                        f"{fname}: a non-finite term off the r < 0 model")
            sname = "sqrt_parallel_smooth" if sqrt else "parallel_smooth"
            sk = kpk.sqrt_parallel_smooth if sqrt else kpk.parallel_smooth
            sp = (kpk.sqrt_parallel_smooth_plain if sqrt
                  else kpk.parallel_smooth_plain)
            full = fp(phi, qq, z, r, y, mask, PK_CHUNK)
            sargs = ((phi, qd) if sqrt else (phi,)) + (
                full[2], full[3], full[0], full[1])
            got = sk(*sargs, PK_CHUNK)
            want = sp(*sargs, PK_CHUNK)
            torch.cuda.synchronize()
            pair(sname, got, want, dtype, bar, case)
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"K19-K22 disagree with their plain versions: {bad}")

    # timing, f32, automatic chunks, beside the sequential twins
    dtype = torch.float32
    times = {}
    rng = np.random.default_rng(SEED + 121)
    shapes = (("one", 1, T_STEPS, (N_SERIES, N_FACTORS)),
              ("fleet", FLEET, T_STEPS, (N_SERIES, N_FACTORS)),
              ("long", 1, PK_LONG[2], PK_LONG[:2]))
    plain_shape = "1 flagship model, T=400, auto chunk, once"
    pl = _pk_case(np.random.default_rng(SEED + 122), 1, PK_T_CMP, dtype,
                  dev)
    pl_qd = torch.diagonal(pl[1], 0, -2, -1).contiguous()
    pl_chunk = kpk.auto_chunk(PK_T_CMP, 1)
    plain_ms = {}
    plain_ms["parallel_filter"], pl_f = cuda_ms(
        lambda: kpk.parallel_filter_plain(*pl, pl_chunk), reps=1, warm=0)
    plain_ms["parallel_smooth"], _ = cuda_ms(
        lambda: kpk.parallel_smooth_plain(pl[0], pl_f[2], pl_f[3], pl_f[0],
                                          pl_f[1], pl_chunk), reps=1, warm=0)
    plain_ms["sqrt_parallel_filter"], pl_s = cuda_ms(
        lambda: kpk.sqrt_parallel_filter_plain(pl[0], pl_qd, *pl[2:],
                                               pl_chunk), reps=1, warm=0)
    plain_ms["sqrt_parallel_smooth"], _ = cuda_ms(
        lambda: kpk.sqrt_parallel_smooth_plain(pl[0], pl_qd, pl_s[2],
                                               pl_s[3], pl_s[0], pl_s[1],
                                               pl_chunk), reps=1, warm=0)
    for key, batch, t, shape in shapes:
        phi, q, z, r, y, mask = _pk_case(rng, batch, t, dtype, dev,
                                         shape=shape)
        qd = torch.diagonal(q, 0, -2, -1).contiguous()
        big_n, n = z.shape[1], z.shape[2]
        chunk = kpk.auto_chunk(t, batch)
        obs = mask.sum(-1).cpu()
        reps = 2 if batch == 1 else 1  # the fleet's launches take 0.2-2 s
        label = (f"{batch} model{'s' if batch > 1 else ''} ({big_n} series, "
                 f"{n - big_n} factor), T={t}, chunk {chunk} "
                 f"({kpk.n_chunks(t, chunk)} chunks), f32")
        mean0 = torch.zeros(batch, n, dtype=dtype, device=dev)
        cov0 = torch.eye(n, dtype=dtype, device=dev).expand(
            batch, n, n).contiguous()
        lanes = (phi.T.contiguous(), qd.T.contiguous(),
                 z.permute(1, 2, 0).contiguous(), r.T.contiguous())
        # the timed launches' outputs against the plain version on the
        # same inputs and chunks: every model, or the first PK_MODELS of
        # the fleet over a window of PK_FLEET_HOLD steps (the fleet runs
        # one chunk a model, so the scan is sequential: the filters' first
        # steps depend on nothing later, the smoothers' last on nothing
        # earlier, and the plain version over the window is the same scan)
        sub = slice(0, min(batch, PK_MODELS))
        win = min(t, PK_FLEET_HOLD) if key == "fleet" else t
        case = (f"{label}, model{'s 0-' if batch > 1 else ' '}{sub.stop - 1}"
                + (f", the filters' first and the smoothers' last {win} "
                   "steps" if win < t else ""))
        cmp_ms = {}

        def held(name, got, plain, *args):
            steps = (slice(t - win, t) if name.endswith("smooth")
                     else slice(0, win))

            def cut(a):  # the time axis is the second, of length t
                return (a[sub][:, steps] if a.dim() >= 2 and a.shape[1] == t
                        else a[sub])

            cmp_ms[name], want = cuda_ms(
                lambda: plain(*(cut(a) for a in args),
                              chunk if win == t else win), reps=1, warm=0)
            pair(name, [cut(g) for g in got], want, dtype, 1e-3, case)

        row = {}
        # the covariance pair and its twin (K1 store + K8)
        ms, f = cuda_ms(lambda: kpk.parallel_filter(phi, q, z, r, y, mask,
                                                    chunk), reps=reps,
                        warm=1)
        held("parallel_filter", f, kpk.parallel_filter_plain, phi, q, z, r,
             y, mask)
        tw, st = cuda_ms(lambda: joint_filter_store(phi, q, z, r, mean0,
                                                    cov0, y, mask),
                         reps=reps, warm=1)
        row["parallel_filter"] = (ms, tw, "K1 store", pk_cost(
            "cov", batch, t, big_n, n, chunk, obs, 4))
        ms, sm = cuda_ms(lambda: kpk.parallel_smooth(phi, f[2], f[3], f[0],
                                                     f[1], chunk),
                         reps=reps, warm=1)
        held("parallel_smooth", sm, kpk.parallel_smooth_plain, phi, f[2],
             f[3], f[0], f[1])
        tw, _ = cuda_ms(lambda: rts_smooth(phi, st[2], st[3], st[0], st[1]),
                        reps=reps, warm=1)
        row["parallel_smooth"] = (ms, tw, "K8", pk_cost(
            "cov_s", batch, t, big_n, n, chunk, obs, 4))
        del f, st, sm
        # the square-root pair and its twin (K9 store + K10)
        ms, f = cuda_ms(lambda: kpk.sqrt_parallel_filter(
            phi, qd, z, r, y, mask, chunk), reps=reps, warm=1)
        held("sqrt_parallel_filter", f, kpk.sqrt_parallel_filter_plain, phi,
             qd, z, r, y, mask)
        tw, st = cuda_ms(lambda: sqrt_filter(*lanes, y, mask, store=True),
                         reps=reps, warm=1)
        row["sqrt_parallel_filter"] = (ms, tw, "K9 store", pk_cost(
            "sqrt", batch, t, big_n, n, chunk, obs, 4))
        ms, sm = cuda_ms(lambda: kpk.sqrt_parallel_smooth(
            phi, qd, f[2], f[3], f[0], f[1], chunk), reps=reps, warm=1)
        held("sqrt_parallel_smooth", sm, kpk.sqrt_parallel_smooth_plain,
             phi, qd, f[2], f[3], f[0], f[1])
        tw, _ = cuda_ms(lambda: sqrt_smooth(phi, qd, st[2], st[3], st[0],
                                            st[1]), reps=reps, warm=1)
        row["sqrt_parallel_smooth"] = (ms, tw, "K10", pk_cost(
            "sqrt_s", batch, t, big_n, n, chunk, obs, 4))
        del f, st, sm
        torch.cuda.empty_cache()
        for name, (ms, tw, twin, cost) in row.items():
            bms, bby = bound_ms(*cost, "float32")
            entry = {"shape": label, "ms": ms, "plain_ms": plain_ms[name],
                     "plain_shape": plain_shape, "bound_ms": bms,
                     "bound_by": bby, "sequential_twin": twin,
                     "sequential_ms": tw, "speedup_vs_sequential": tw / ms,
                     "plain_cmp_ms": cmp_ms[name], "plain_cmp_case": case}
            times[name if key == "one" else f"{name}_{key}"] = entry
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"K19-K22's timed launches disagree with their plain "
            f"versions: {bad}")
    emit({"phase": "pkalman_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar", "ok")}
        for c in checks], "times": times})
    return checks, times


SHARD_NAMES = tuple(f"{base}_{mode}" for base in ("parallel_filter",
                                                   "parallel_smooth")
                    for mode in ("total", "carry", "prefix"))
MESH_DEVICES = 4  # the mesh path's virtual mesh: four devices, all the card
SHARD_T_CMP = 400  # steps of the modes' kernel-vs-plain comparison ...
SHARD_CHUNK = 16  # ... in 4 shards of 100 steps, chunks of 16 (a ragged 4)


def pk_mode_cost(kind, mode, batch, t_steps, big_n, n, chunk, obs,
                 itemsize, shards=MESH_DEVICES, origin=False):
    """Bytes and operations of one sharded-mode launch of K19 (``kind``
    "cov") or K20 ("cov_s") over one shard of ``t_steps`` steps: the
    shard's model and data (or stored filter) read once, the chunk totals
    and the incoming moment read once where the mode reads them, the
    outputs written once; operations as :func:`pk_cost` counts them —
    every step's element (and a filter's tails) once, ``total``'s T - 1
    full combines (each chunk's up-sweep and the fold of the chunk
    totals), ``carry``'s S - 2 reduced combines over S totals,
    ``prefix``'s carry over the chunk totals and a reduced combine per
    step (the origin's first step seeds)."""
    import collections

    c = -(-t_steps // chunk)
    full_n = (3 * n * n + 2 * n) if kind == "cov" else (2 * n * n + n)
    mom_n = n * n + n
    _, full, red, _ = _pk_step_ops(kind, n, 0)
    if mode == "carry":
        return ((batch * shards * full_n + batch * (shards - 1) * mom_n)
                * itemsize, batch * max(shards - 2, 0) * red)
    if kind == "cov":
        read = (batch * (n + n * n + big_n * n + big_n) * itemsize
                + batch * t_steps * big_n * (itemsize + 1))
        counts = collections.Counter(obs.flatten().tolist())
        per_step = sum(
            cnt * (_pk_step_ops(kind, n, o)[0]
                   + (_pk_step_ops(kind, n, o)[3] if mode == "prefix" else 0))
            for o, cnt in counts.items())
        out_step = 2 * n + 2 * n * n + 2
    else:
        read = (batch * n + batch * t_steps * (2 * n + 2 * n * n)
                + (0 if origin else batch * mom_n)) * itemsize
        per_step = batch * t_steps * _pk_step_ops(kind, n, 0)[0]
        out_step = n + n * n
    if mode == "total":
        nbytes = read + batch * (c + 1) * full_n * itemsize
        return nbytes, per_step + batch * (t_steps - 1) * full
    nbytes = (read + batch * (max(c - 1, 0) * full_n
                              + (0 if origin else mom_n)) * itemsize
              + batch * t_steps * out_step * itemsize)
    carry = max(c - 1, 0) - (1 if origin and c > 1 else 0)
    steps = t_steps - (1 if origin else 0)
    return nbytes, per_step + batch * (carry + steps) * red


def _shard_run(kpk, args, shards, chunk, plain=False):
    """Every sharded mode of K19 then K20 over ``shards`` even shards of
    ``args`` (phi, q, z, r, y, mask), as ``sequence_sharded_filter`` runs
    them on one device; ``plain`` runs the plain versions.  Returns each
    mode's outputs by name: a list over shards (``carry``: one)."""
    phi, q, z, r, y, mask = args
    sfx = "_plain" if plain else ""
    n, tl = phi.shape[-1], y.shape[1] // shards
    cut = [slice(k * tl, (k + 1) * tl) for k in range(shards)]
    out = {}
    fn = getattr(kpk, "parallel_filter_total" + sfx)
    out["parallel_filter_total"] = [
        fn(phi, q, z, r, y[:, sl], mask[:, sl], chunk, k == 0)
        for k, sl in enumerate(cut)]
    pre = getattr(kpk, "parallel_filter_carry" + sfx)(
        torch_stack([t[0] for t in out["parallel_filter_total"]]), n)
    out["parallel_filter_carry"] = [pre]
    fn = getattr(kpk, "parallel_filter_prefix" + sfx)
    filt = out["parallel_filter_prefix"] = [
        fn(phi, q, z, r, y[:, sl], mask[:, sl], chunk,
           out["parallel_filter_total"][k][1],
           None if k == 0 else pre[:, k - 1].contiguous())
        for k, sl in enumerate(cut)]
    halo = [None if k == shards - 1 else
            (filt[k + 1][0][:, 0].contiguous(),
             filt[k + 1][1][:, 0].contiguous()) for k in range(shards)]
    fn = getattr(kpk, "parallel_smooth_total" + sfx)
    stot = out["parallel_smooth_total"] = [
        fn(phi, filt[k][2], filt[k][3], filt[k][0], filt[k][1], chunk,
           halo[k]) for k in range(shards)]
    spre = getattr(kpk, "parallel_smooth_carry" + sfx)(
        torch_stack([stot[k][0] for k in reversed(range(shards))]), n)
    out["parallel_smooth_carry"] = [spre]
    fn = getattr(kpk, "parallel_smooth_prefix" + sfx)
    out["parallel_smooth_prefix"] = [
        fn(phi, filt[k][2], filt[k][3], filt[k][0], filt[k][1], chunk,
           stot[k][1],
           None if k == shards - 1 else
           spre[:, shards - 2 - k].contiguous(), halo[k])
        for k in range(shards)]
    return out


def torch_stack(parts):
    import torch

    return torch.stack(parts, dim=1).contiguous()


def _mode_checks(kpk, args, chunk, want, case, dtype, bar):
    """Each sharded mode's kernel on every shard of ``args`` fed the
    inputs its plain version had in the plain chain ``want`` (a
    :func:`_shard_run` with ``plain=True``), held to that version's
    outputs: a list of :func:`check_entry` results."""
    import torch

    phi, q, z, r, y, mask = args
    tl = y.shape[1] // MESH_DEVICES
    checks = []
    for name in SHARD_NAMES:
        for k, w in enumerate(want[name]):
            sl = slice(k * tl, (k + 1) * tl)
            if name == "parallel_filter_total":
                margs = (phi, q, z, r, y[:, sl], mask[:, sl], chunk, k == 0)
            elif name == "parallel_filter_prefix":
                margs = (phi, q, z, r, y[:, sl], mask[:, sl], chunk,
                         want["parallel_filter_total"][k][1],
                         None if k == 0 else want[
                             "parallel_filter_carry"][0][:, k - 1]
                         .contiguous())
            elif name.endswith("carry"):
                src = ("parallel_filter_total" if "filter" in name
                       else "parallel_smooth_total")
                order = (range(MESH_DEVICES) if "filter" in name
                         else reversed(range(MESH_DEVICES)))
                margs = (torch_stack([want[src][j][0] for j in order]),
                         phi.shape[-1])
                w = (w,)
            else:
                f = want["parallel_filter_prefix"]
                halo = (None if k == MESH_DEVICES - 1 else
                        (f[k + 1][0][:, 0].contiguous(),
                         f[k + 1][1][:, 0].contiguous()))
                margs = (phi, f[k][2], f[k][3], f[k][0], f[k][1], chunk)
                if name == "parallel_smooth_total":
                    margs += (halo,)
                else:
                    spre = want["parallel_smooth_carry"][0]
                    margs += (want["parallel_smooth_total"][k][1],
                              None if halo is None else
                              spre[:, MESH_DEVICES - 2 - k].contiguous(),
                              halo)
            got = getattr(kpk, name + "_kernel")(*margs)
            if name.endswith("carry"):
                got = (got,)
            torch.cuda.synchronize()
            checks.append(check_entry(name, f"{case}, shard {k}", dtype,
                                      list(got), list(w), bar))
    return checks


def phase_sharded_scan_kernels():
    """K19/K20's sharded modes (``total``, ``carry``, ``prefix``) against
    their plain versions on the card on the same shards and chunks, f64
    (1e-9) and f32 (1e-3), normwise and NaN-strict: PK_MODELS flagship
    models over SHARD_T_CMP steps in MESH_DEVICES shards of 100 steps,
    chunks of SHARD_CHUNK (a ragged tail), two all-missing steps, the last
    model observing a slot with r < 0, each mode's kernel fed the same
    inputs as its plain version (the plain chain's).  Then, in f32 at the
    mesh path's shapes — the long-context model (T = 32,768 over
    MESH_DEVICES shards) and one flagship model (T = 5,000), the automatic
    chunk length of a shard — every mode of every shard held the same way
    (1e-3), and each mode timed at a middle shard (no origin: an incoming
    moment and, for K20, a halo) beside its plain version, once, on the
    same inputs."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import pkalman as kpk

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    checks = []
    for dtype, bar in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        args = _pk_case(np.random.default_rng(SEED + 140), PK_MODELS,
                        SHARD_T_CMP, dtype, dev, stress=True)
        case = (f"{PK_MODELS} flagship models, {MESH_DEVICES} shards of "
                f"{SHARD_T_CMP // MESH_DEVICES} steps, chunk {SHARD_CHUNK}, "
                "masked steps, r < 0 in the last")
        want = _shard_run(kpk, args, MESH_DEVICES, SHARD_CHUNK, plain=True)
        checks += _mode_checks(kpk, args, SHARD_CHUNK, want, case, dtype,
                               bar)
    # the mesh path's shapes, f32: every mode of every shard held to its
    # plain version on the same card, then each mode timed at a middle
    # shard (no origin: an incoming moment and, for K20, a halo) beside
    # its plain version on the same inputs
    dtype = torch.float32
    times = {}
    rng = np.random.default_rng(SEED + 141)
    for key, t, shape in (("long", PK_LONG[2], PK_LONG[:2]),
                          ("flagship", T_STEPS, (N_SERIES, N_FACTORS))):
        args = _pk_case(rng, 1, t, dtype, dev, shape=shape)
        phi, q, z, r, y, mask = args
        big_n, n = z.shape[1], z.shape[2]
        tl = t // MESH_DEVICES
        chunk = kpk.auto_chunk(tl, 1)
        label = (f"1 model ({big_n} series, {n - big_n} factor), "
                 f"{MESH_DEVICES} shards of T={t} ({tl} steps, chunk "
                 f"{chunk}, {kpk.n_chunks(tl, chunk)} chunks), f32")
        run = _shard_run(kpk, args, MESH_DEVICES, chunk, plain=True)
        checks += _mode_checks(kpk, args, chunk, run, label, dtype, 1e-3)
        k = 1
        sl = slice(k * tl, (k + 1) * tl)
        ys, ms_ = y[:, sl], mask[:, sl]
        obs = ms_.sum(-1).cpu()
        filt = run["parallel_filter_prefix"]
        halo = (filt[k + 1][0][:, 0].contiguous(),
                filt[k + 1][1][:, 0].contiguous())
        sargs = (phi, filt[k][2], filt[k][3], filt[k][0], filt[k][1], chunk)
        calls = {
            "parallel_filter_total": (
                (phi, q, z, r, ys, ms_, chunk, False), "cov", "total"),
            "parallel_filter_carry": (
                (torch_stack([x[0] for x in run["parallel_filter_total"]]),
                 n), "cov", "carry"),
            "parallel_filter_prefix": (
                (phi, q, z, r, ys, ms_, chunk,
                 run["parallel_filter_total"][k][1],
                 run["parallel_filter_carry"][0][:, k - 1].contiguous()),
                "cov", "prefix"),
            "parallel_smooth_total": ((*sargs, halo), "cov_s", "total"),
            "parallel_smooth_carry": (
                (torch_stack([x[0] for x in
                              reversed(run["parallel_smooth_total"])]), n),
                "cov_s", "carry"),
            "parallel_smooth_prefix": (
                (*sargs, run["parallel_smooth_total"][k][1],
                 run["parallel_smooth_carry"][0][
                     :, MESH_DEVICES - 2 - k].contiguous(), halo),
                "cov_s", "prefix"),
        }
        for name, (margs, kind, mode) in calls.items():
            ms, _ = cuda_ms(lambda m=margs, f=getattr(kpk, name): f(*m),
                            reps=5, warm=1)
            plain_ms, _ = cuda_ms(
                lambda m=margs, f=getattr(kpk, name + "_plain"): f(*m),
                reps=1, warm=0)
            cost = pk_mode_cost(kind, mode, 1, tl, big_n, n, chunk, obs, 4)
            bms, bby = bound_ms(*cost, "float32")
            shape = (f"1 model ({big_n} series, {n - big_n} factor), "
                     f"{MESH_DEVICES} shard totals, f32" if mode == "carry"
                     else f"shard {k} of {label}")
            times[name if key == "long" else f"{name}_{key}"] = {
                "shape": shape, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": bby}
        del run
        torch.cuda.empty_cache()
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"K19/K20's sharded modes disagree with their plain "
            f"versions: {bad}")
    emit({"phase": "sharded_scan_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar", "ok")}
        for c in checks], "times": times,
        "wall_s": time.perf_counter() - t_phase})
    return checks, times


MESH_BATCH = 16  # flagship models of the mesh path's batch fit ...
MESH_BATCH_T = 1_000  # ... over their first 1,000 steps (depth cut)
MESH_BATCH_FIT = dict(maxiter=20, tol=0.05, stall_tol=1e-3)
MESH_ARENA_ROWS = 512  # rows of the sharded arena: 129 a shard, so the
#                        512 models touch every shard
MESH_ARENA_ROUNDS = 3


def _mesh_arena_run(states, rows, mesh, kw):
    """A per-request arena service on ``ModelRegistry(arena=True,
    arena_mesh=mesh)`` taking ``rows`` (a list of (B, 1, N) rounds), one
    bulk tick of the last round, and 14-step forecasts; returns the
    registry's posteriors, versions, t_seen, the acks and the forecasts."""
    import numpy as np

    from metran_tpu_torch.serve import MetranService, ModelRegistry

    reg = ModelRegistry(arena=True, arena_rows=MESH_ARENA_ROWS,
                        arena_mesh=mesh, engine="joint", device=DEVICE)
    for st in states:
        reg.put(st, persist=False)
    svc = MetranService(reg, flush_deadline=None, persist_updates=False,
                        device=DEVICE, **kw)
    ids = [st.model_id for st in states]
    acks = []
    for obs in rows:
        futs = [svc.update_async(mid, obs[i]) for i, mid in enumerate(ids)]
        svc.flush()
        acks.append([_result(f) for f in futs])
    acks.append(svc.update_batch(ids, list(rows[-1])))
    fcs = svc.forecast_batch(ids, FORECAST_STEPS)
    out = {"acks": [[(a.version, a.t_seen) if hasattr(a, "version")
                     else type(a).__name__ for a in r] for r in acks],
           "forecasts": fcs}
    got = [reg.get(mid) for mid in ids]
    out.update(mean=np.stack([g.mean for g in got]),
               cov=np.stack([g.cov for g in got]),
               version=[g.version for g in got],
               t_seen=[g.t_seen for g in got])
    arena = next(iter(reg._arenas.values()))
    out["shards"] = len(arena.devices)
    out["touched"] = len({reg._row_map[m][1] // arena.shard_rows
                          for m in ids})
    svc.close()
    return out


def _result(fut):
    try:
        return fut.result()
    except Exception as exc:  # noqa: BLE001 - per-slot failures ride along
        return exc


def phase_mesh_path(fit):
    """The mesh path (A6's mesh half) on a virtual mesh of MESH_DEVICES
    devices, all the card: ``sequence_sharded_filter`` (K19/K20 ``total``
    -> ``carry`` -> ``prefix``) on the long-context model (8 series, 1
    factor, T = 32,768) and on one flagship model (T = 5,000), held to
    the unsharded K19/K20 on the same card (1e-5 normwise, f32) and timed
    beside them; ``fit_fleet(layout="lanes", mesh=...)`` on phase 5's 512
    flagship models from its start, against the unsharded fit run right
    after it (both uninstrumented, walls back to back) at the JAX bars
    (deviance rtol 1e-6, parameters rtol 1e-4 / atol 1e-6);
    a MESH_BATCH-model batch fit (K1 ``bounds`` + K11) with the mesh
    against the same fit without it (deviances within GAP_BAR); and a
    gated, detecting ``ModelRegistry(arena=True, arena_mesh=4)`` serving
    the 512 flagship posteriors for MESH_ARENA_ROUNDS rounds, a bulk tick
    and a forecast, bit for bit an ``arena_mesh=0`` registry.  With more
    than one card, ``sequence_sharded_filter`` also runs on a real mesh of
    the cards.  The launch counts are the sharded calls' own (reset
    before them, read before any unsharded reference runs): every mode
    of K19/K20 must have run."""
    import os

    import numpy as np
    import torch

    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.ops import pkalman as pops
    from metran_tpu_torch.ops.statespace import StateSpace
    from metran_tpu_torch.parallel import (
        autocorr_init_params,
        fit_fleet,
        make_mesh,
        pack_fleet,
    )
    from metran_tpu_torch.serve import DetectSpec, GateSpec

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    seq_mesh = make_mesh(MESH_DEVICES, ("seq",), devices=[dev] * MESH_DEVICES)
    batch_mesh = make_mesh(MESH_DEVICES, devices=[dev] * MESH_DEVICES)
    rng = np.random.default_rng(SEED + 150)
    cases = {}
    for key, t, shape in (("long", PK_LONG[2], PK_LONG[:2]),
                          ("flagship", T_STEPS, (N_SERIES, N_FACTORS))):
        phi, q, z, r, y, mask = _pk_case(rng, 1, t, torch.float32, dev,
                                         shape=shape)
        cases[key] = (StateSpace(phi[0], q[0], z[0], r[0]), y[0], mask[0])
    # the batch fit's fleet
    yb, mb, ldb, _, _ = make_workload(rng, MESH_BATCH, t=MESH_BATCH_T)
    from metran_tpu_torch.data import Panel

    names = [f"s{j}" for j in range(N_SERIES)]
    bfleet = pack_fleet([Panel(yb[i].astype(np.float32), mb[i], None, names,
                               np.ones(N_SERIES), np.zeros(N_SERIES), 1.0)
                         for i in range(MESH_BATCH)], list(ldb),
                        dtype=torch.float32, device=dev)
    bp0 = autocorr_init_params(bfleet)
    # the arena's states and rounds
    states, arena_rows = _fleet_states("joint", rng, T_STEPS, MISSING)
    rounds = [np.array(arena_rows[:, j:j + 1], dtype=float)
              for j in range(MESH_ARENA_ROUNDS)]
    rounds[1][10:30, 0, 4] += GATE_SPIKE
    arena_kw = dict(gate=GateSpec("reject", nsigma=GATE_NSIGMA, min_seen=32),
                    detect=DetectSpec(enabled=True))
    torch.cuda.synchronize()

    # the sharded path, counted
    reset_launches()
    out = {"phase": "mesh_path", "mesh": MESH_DEVICES,
           "devices": "virtual (all cuda:0)"}
    seq = {key: pops.sequence_sharded_filter(*case, seq_mesh)
           for key, case in cases.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = fit_fleet(bfleet, p0=bp0, mesh=batch_mesh, **MESH_BATCH_FIT)
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t0
    virtual = os.environ.get("METRAN_TPU_VIRTUAL_DEVICES")
    os.environ["METRAN_TPU_VIRTUAL_DEVICES"] = str(MESH_DEVICES)
    try:
        t0 = time.perf_counter()
        sharded_arena = _mesh_arena_run(states, rounds, MESH_DEVICES,
                                        arena_kw)
        arena_wall = time.perf_counter() - t0
    finally:
        if virtual is None:
            os.environ.pop("METRAN_TPU_VIRTUAL_DEVICES")
        else:
            os.environ["METRAN_TPU_VIRTUAL_DEVICES"] = virtual
    # the lanes fit last, so that the unsharded fit runs right after it:
    # two uninstrumented walls back to back
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes = fit_fleet(fit["fleet"], p0=fit["p0"], mesh=batch_mesh, **FIT)
    torch.cuda.synchronize()
    lanes_wall = time.perf_counter() - t0
    counts = launches()
    t0 = time.perf_counter()
    base = fit_fleet(fit["fleet"], p0=fit["p0"], **FIT)
    torch.cuda.synchronize()
    base_wall = time.perf_counter() - t0
    for name in SHARD_NAMES:
        require(counts[name] > 0, f"the mesh path never launched {name}")
    for name in ("lanes_filter", "lanes_adjoint", "joint_filter_append",
                 "joint_adjoint", "arena_update", "arena_forecast"):
        require(counts[name] > 0, f"the mesh path never launched {name}")
    out["launches"] = {k: v for k, v in counts.items() if v}

    # (a) the sharded scan against the unsharded K19/K20, timed beside
    seq_out = {}
    fields = ("mean_p", "cov_p", "mean_f", "cov_f", "sigma", "detf",
              "mean_s", "cov_s")
    for key, case in cases.items():
        def unsharded(case=case):
            f = pops.parallel_filter(*case)
            return f, pops.parallel_smoother(case[0], f)

        want = unsharded()
        got = seq[key]
        torch.cuda.synchronize()
        errs = {fld: rel_err(g, w) for fld, g, w in
                zip(fields, (*got[0], *got[1]), (*want[0], *want[1]))}
        require(within(list(errs.values()), 1e-5),
                f"{key}: sharded scan vs unsharded K19/K20 {errs}")
        ms_sh, _ = cuda_ms(lambda case=case: pops.sequence_sharded_filter(
            *case, seq_mesh), reps=3, warm=1)
        ms_un, _ = cuda_ms(unsharded, reps=3, warm=1)
        t_steps, big_n = case[1].shape
        seq_out[key] = {"t_steps": t_steps, "series": big_n,
                        "rel_err": errs, "sharded_ms": ms_sh,
                        "unsharded_ms": ms_un,
                        "sharded_over_unsharded": ms_sh / ms_un}
    out["sequence_sharded"] = seq_out
    if torch.cuda.device_count() > 1:
        cards = [torch.device("cuda", i)
                 for i in range(min(torch.cuda.device_count(),
                                    MESH_DEVICES))]
        real = make_mesh(len(cards), ("seq",), devices=cards)
        case = cases["long"]
        got = pops.sequence_sharded_filter(*case, real)
        want = pops.sequence_sharded_filter(*case, seq_mesh)
        errs = [rel_err(g, w.to(g.device)) for g, w in
                zip((*got[0], *got[1]), (*want[0], *want[1]))]
        require(within(errs, 1e-5), f"real mesh vs virtual mesh {errs}")
        out["real_mesh"] = {"cards": len(cards), "rel_err": max(errs)}

    # (b) the lanes fit against the unsharded fit (the JAX bars)
    d_got, d_want = lanes.deviance.cpu().numpy(), base.deviance.cpu().numpy()
    p_got, p_want = lanes.params.cpu().numpy(), base.params.cpu().numpy()
    dev_rel = np.abs(d_got - d_want) / np.abs(d_want)
    par_ok = np.abs(p_got - p_want) <= 1e-6 + 1e-4 * np.abs(p_want)
    require(bool((dev_rel <= 1e-6).all()) and bool(par_ok.all()),
            f"sharded lanes fit vs unsharded: deviance rel "
            f"{float(dev_rel.max())}, parameters off at "
            f"{int((~par_ok).sum())} entries")
    out["lanes_fit"] = {
        "models": int(d_got.size), "wall_s": lanes_wall,
        "unsharded_wall_s": base_wall,
        "unsharded_equals_phase_5": bool(
            torch.equal(base.params.cpu(), fit["fit"].params.cpu())),
        "deviance_rel_max": float(dev_rel.max()),
        "params_abs_max": float(np.abs(p_got - p_want).max()),
        "bitwise": bool(np.array_equal(d_got, d_want)
                        and np.array_equal(p_got, p_want)),
        "iterations_equal": bool(torch.equal(lanes.iterations.cpu(),
                                             base.iterations.cpu()))}

    # (c) the batch fit with and without the mesh
    t0 = time.perf_counter()
    bbase = fit_fleet(bfleet, p0=bp0, **MESH_BATCH_FIT)
    torch.cuda.synchronize()
    bbase_wall = time.perf_counter() - t0
    bd, bw = batch.deviance.cpu().numpy(), bbase.deviance.cpu().numpy()
    require(np.isfinite(bd).all() and np.isfinite(batch.params.cpu().numpy())
            .all(), "the sharded batch fit ended non-finite")
    brel = np.abs(bd - bw) / np.abs(bw)
    require(within(brel.tolist(), GAP_BAR),
            f"sharded batch fit vs unsharded: {brel}")
    out["batch_fit"] = {
        "models": MESH_BATCH, "t_steps": MESH_BATCH_T,
        "settings": MESH_BATCH_FIT, "wall_s": batch_wall,
        "unsharded_wall_s": bbase_wall, "deviance_rel_max": float(brel.max()),
        "params_rel_max": float(np.max(
            np.abs(batch.params.cpu().numpy() - bbase.params.cpu().numpy())
            / np.abs(bbase.params.cpu().numpy()))),
        "bitwise": bool(np.array_equal(bd, bw))}

    # (d) the sharded arena against the unsharded one, bit for bit
    t0 = time.perf_counter()
    one = _mesh_arena_run(states, rounds, 0, arena_kw)
    one_wall = time.perf_counter() - t0
    same = (sharded_arena["acks"] == one["acks"]
            and np.array_equal(sharded_arena["mean"], one["mean"],
                               equal_nan=True)
            and np.array_equal(sharded_arena["cov"], one["cov"],
                               equal_nan=True)
            and sharded_arena["version"] == one["version"]
            and sharded_arena["t_seen"] == one["t_seen"]
            and all(np.array_equal(a.means, b.means)
                    and np.array_equal(a.variances, b.variances)
                    and a.version == b.version
                    for a, b in zip(sharded_arena["forecasts"],
                                    one["forecasts"])))
    require(same, "the sharded arena differs from the unsharded one")
    require(sharded_arena["touched"] == MESH_DEVICES,
            f"the models touched {sharded_arena['touched']} shards")
    out["arena"] = {"models": len(states), "rounds": MESH_ARENA_ROUNDS,
                    "shards": sharded_arena["shards"],
                    "shards_touched": sharded_arena["touched"],
                    "bitwise": same, "wall_s": arena_wall,
                    "unsharded_wall_s": one_wall}
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return counts


PK_SERVE_MODELS = 4  # flagship models the sqrt_parallel registry serves
PK_SERVE_ROUNDS = 4  # their update rounds (k = 1)


def phase_parallel_path(pool, mt64, out64):
    """The associative-scan engines through ``Metran`` on the card: the
    example in f64 on ``engine="parallel"`` and ``"sqrt_parallel"`` at
    the fitted table of the f64 sequential run (``mt64``), held to the
    golden rows and to that run's products (``out64``) within 1e-9; one
    flagship model in f32 on each engine, solved by LanesSolve and held
    (every product) to CPU f64 recomputes of the port in ``pool``'s
    workers (1e-3; deviances 1e-4, the engine's own from K19/K21's
    terms included); then a ``MetranService`` on ``ModelRegistry(engine=
    "sqrt_parallel")`` serving PK_SERVE_MODELS copies of the
    ``sqrt_parallel`` model's state (its K21 factor) for PK_SERVE_ROUNDS
    update rounds and a forecast, equal bit for bit to an
    ``engine="sqrt"`` registry fed the same states.  The launch counters
    are reset before and read after: K19/K20 and K21/K22 must have run,
    the draws on K1 ``store`` + K8 and K9 + K10."""
    import json
    import os

    import numpy as np
    import torch

    from metran_tpu_torch import Metran
    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.serve import MetranService, ModelRegistry
    from metran_tpu_torch.serve.state import posterior_state_from_metran

    golden = json.loads(GOLDEN.read_text())
    dev = torch.device(DEVICE)
    series = example_series()
    name_ex, name_f = f"{EXAMPLE}005", "s03"
    rows = golden["state_means_rows_idx"]
    out = {"phase": "parallel_path"}
    jobs, card = {}, {}
    reset_launches()
    with _KernelTimer() as timer:
        for engine in ("parallel", "sqrt_parallel"):
            before = launches()
            # the example in f64 at the sequential run's fitted table
            os.environ["METRAN_TPU_X64"] = "1"
            try:
                mt = Metran(series, name=EXAMPLE, engine=engine)
            finally:
                del os.environ["METRAN_TPU_X64"]
            require(mt.dtype == torch.float64 and mt._engine == engine,
                    (mt.dtype, mt._engine))
            mt.get_factors(mt.oseries)
            mt.set_init_parameters()
            require(np.array_equal(mt.factors, mt64.factors),
                    f"{engine}: other factors than the f64 run")
            mt.parameters["optimal"] = mt64.parameters["optimal"]
            prods, stats = metran_products(mt, name_ex, timer)
            frames = {**prods,
                      "decompose": mt.decompose_simulation(f"{EXAMPLE}001")}
            golden_err = {}
            for key, (gkey, bar) in GOLDEN_ROWS.items():
                err = float(np.abs(frames[key].iloc[rows].values
                                   - np.asarray(golden[gkey])).max())
                golden_err[key] = err
                require(err <= bar, f"f64 {engine} {key} rows off golden "
                                    f"by {err}")
            vs_seq = {key: rel_err(
                torch.as_tensor(np.array(prods[key].values, float)),
                torch.as_tensor(np.array(out64[key].values, float)))
                for key in (*METRAN_COMPARED, "sample")}
            require(within(list(vs_seq.values()), 1e-9),
                    f"f64 {engine} vs sequential products: {vs_seq}")
            # one flagship model in f32, solved on the card's LanesSolve
            mtf = Metran(flagship_series(SEED + 70), name="flagship",
                         engine=engine)
            require(mtf.dtype == torch.float32, mtf.dtype)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mtf.solve(report=False)
            torch.cuda.synchronize()
            solve_s = time.perf_counter() - t0
            jobs[engine] = pool.submit(
                cpu_metran, "flagship", mtf.parameters["optimal"], name_f,
                card_normals(mtf, dev), engine)
            prods_f, stats_f = metran_products(mtf, name_f, timer)
            require(all(np.isfinite(prods_f[k].values).all() for k in (
                "state_means", "state_variances", "simulated_means",
                "simulated_variances", "decompose", "forecast", "sample")),
                    f"{engine}: a non-finite flagship product")
            after = launches()
            card[engine] = (mtf, prods_f)
            out[engine] = {
                "example_f64": {"golden_abs_err": golden_err,
                                "rel_err_vs_sequential": vs_seq,
                                "products": stats},
                "flagship_f32": {"solve_s": solve_s,
                                 "obj_func": mtf.fit.obj_func,
                                 "iterations": int(
                                     mtf.fit.fleet_fit.iterations[0]),
                                 "products": stats_f},
                "launches": {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}}
        # the sqrt_parallel registry against the sqrt one, bit for bit
        mtf = card["sqrt_parallel"][0]
        st = posterior_state_from_metran(mtf, model_id="m0")
        require(st.chol is not None, "sqrt_parallel state without a factor")
        states = [st._replace(model_id=f"m{i}")
                  for i in range(PK_SERVE_MODELS)]
        ids = [s.model_id for s in states]
        results = {}
        rng = np.random.default_rng(SEED + 123)
        obs = rng.normal(size=(PK_SERVE_ROUNDS, PK_SERVE_MODELS, 1,
                               N_SERIES))
        obs[rng.uniform(size=obs.shape) < 0.3] = np.nan
        for engine in ("sqrt_parallel", "sqrt"):
            reg = ModelRegistry(root=None, engine=engine)
            for s in states:
                reg.put(s, persist=False)
            svc = MetranService(reg, flush_deadline=None,
                                persist_updates=False)
            got = []
            for k in range(PK_SERVE_ROUNDS):
                futs = [svc.update_async(m, obs[k, i])
                        for i, m in enumerate(ids)]
                svc.flush()
                got += [f.result() for f in futs]
            got += svc.forecast_batch(ids, FORECAST_STEPS)
            svc.close()
            results[engine] = got
        same = all(
            type(a) is type(b) and all(
                np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("mean", "cov", "chol", "means", "variances")
                if hasattr(a, f))
            for a, b in zip(results["sqrt_parallel"], results["sqrt"]))
        require(same and len(results["sqrt"]) == len(results["sqrt_parallel"]),
                "the sqrt_parallel registry differs from the sqrt one")
        counts = launches()
    for engine, kerns in (("parallel", ("parallel_filter", "parallel_smooth",
                                        "joint_filter_store", "rts_smooth",
                                        "lanes_sample", "forecast_moments",
                                        "lanes_filter", "lanes_adjoint")),
                          ("sqrt_parallel", ("sqrt_parallel_filter",
                                             "sqrt_parallel_smooth",
                                             "sqrt_filter", "sqrt_smooth"))):
        for kern in kerns:
            require(out[engine]["launches"].get(kern, 0) > 0,
                    f"{engine} path never launched {kern}")
    # the card's f32 flagship products against the CPU f64 recomputes
    cpu_err = {}
    for engine, (mtf, prods_f) in card.items():
        cpu = jobs[engine].result()
        errs = {key: rel_err(torch.as_tensor(np.array(prods_f[key].values,
                                                      float)),
                             torch.as_tensor(cpu[key]))
                for key in METRAN_COMPARED}
        errs["sample"] = rel_err(
            torch.as_tensor(np.array(prods_f["sample"].values[:, :CPU_DRAWS])),
            torch.as_tensor(cpu["sample"]))
        errs["deviance"] = abs(mtf.fit.obj_func - cpu["deviance"]) / abs(
            cpu["deviance"])
        engine_dev = mtf.kf.get_mle(mtf.settings["warmup"])
        errs["engine_deviance"] = abs(engine_dev - cpu["deviance"]) / abs(
            cpu["deviance"])
        cpu_err[engine] = errs
        require(within([errs[k] for k in (*METRAN_COMPARED, "sample")],
                       1e-3), f"{engine}: card f32 vs CPU f64 {errs}")
        require(errs["deviance"] <= 1e-4 and errs["engine_deviance"] <= 1e-4,
                f"{engine}: card f32 deviance vs CPU f64 {errs}")
    out.update({"launches": counts, "cpu_f64_rel_err": cpu_err,
                "registry_bitwise_vs_sqrt": same,
                "registry_results": len(results["sqrt"])})
    emit(out)
    return counts


KERNELS = {
    "joint_filter_append": {
        "source": "metran_tpu_torch/kernels/csrc/joint_filter.cu",
        "replaces": "metran_tpu/ops/kalman.py:329",
    },
    "forecast_moments": {
        "source": "metran_tpu_torch/kernels/csrc/forecast.cu",
        "replaces": "metran_tpu/ops/forecast.py:76",
    },
    "lanes_filter": {
        "source": "metran_tpu_torch/kernels/csrc/lanes_filter.cu",
        "replaces": "metran_tpu/ops/lanes.py:104",
    },
    # the warp kernel K3's chain kernel replaced: its bit-for-bit oracle,
    # launched by no path
    "lanes_filter_warp": {
        "source": "metran_tpu_torch/kernels/csrc/lanes_filter_warp.cu",
        "replaces": "metran_tpu/ops/lanes.py:104",
    },
    "lanes_adjoint": {
        "source": "metran_tpu_torch/kernels/csrc/lanes_adjoint.cu",
        "replaces": "metran_tpu/ops/lanes.py:232",
    },
    # the warp kernel K4's ring kernel replaced: its bit-for-bit oracle,
    # launched by no path
    "lanes_adjoint_warp": {
        "source": "metran_tpu_torch/kernels/csrc/lanes_adjoint_warp.cu",
        "replaces": "metran_tpu/ops/lanes.py:232",
    },
    "lanes_smooth_bwd": {
        "source": "metran_tpu_torch/kernels/csrc/lanes_smooth.cu",
        "replaces": "metran_tpu/ops/lanes_products.py:126",
    },
    "lanes_forward": {
        "source": "metran_tpu_torch/kernels/csrc/lanes_forward.cu",
        "replaces": "metran_tpu/ops/lanes_products.py:224",
    },
    "lanes_sample": {
        "source": "metran_tpu_torch/kernels/csrc/lanes_sample.cu",
        "replaces": "metran_tpu/ops/lanes_products.py:372",
    },
    "rts_smooth": {
        "source": "metran_tpu_torch/kernels/csrc/rts_smoother.cu",
        "replaces": "metran_tpu/ops/kalman.py:1771",
    },
    "sqrt_filter": {
        "source": "metran_tpu_torch/kernels/csrc/sqrt_filter.cu",
        "replaces": "metran_tpu/ops/kalman.py:578",
    },
    "sqrt_smooth": {
        "source": "metran_tpu_torch/kernels/csrc/sqrt_smoother.cu",
        "replaces": "metran_tpu/ops/kalman.py:1829",
    },
    "joint_adjoint": {
        "source": "metran_tpu_torch/kernels/csrc/joint_adjoint.cu",
        "replaces": "metran_tpu/ops/adjoint.py:212",
    },
    "joint_filter_store": {
        "source": "metran_tpu_torch/kernels/csrc/joint_filter.cu",
        "replaces": "metran_tpu/ops/kalman.py:188",
    },
    # the block kernel the warp kernel replaced: its bit-for-bit oracle,
    # launched by no path
    "joint_filter_append_block": {
        "source": "metran_tpu_torch/kernels/csrc/joint_filter.cu",
        "replaces": "metran_tpu/ops/kalman.py:329",
    },
    "gated_filter": {
        "source": "metran_tpu_torch/kernels/csrc/gated_filter.cu",
        "replaces": "metran_tpu/ops/kalman.py:734",
    },
    "sqrt_filter_gated": {
        "source": "metran_tpu_torch/kernels/csrc/sqrt_filter.cu",
        "replaces": "metran_tpu/ops/kalman.py:838",
    },
    # the block kernel K9's group kernel replaced: its bit-for-bit oracle,
    # launched by no path
    "sqrt_filter_block": {
        "source": "metran_tpu_torch/kernels/csrc/sqrt_filter_block.cu",
        "replaces": "metran_tpu/ops/kalman.py:578",
    },
    "detect": {
        "source": "metran_tpu_torch/kernels/csrc/detect.cu",
        "replaces": "metran_tpu/ops/detect.py:104",
    },
    "gated_filter_robust": {
        "source": "metran_tpu_torch/kernels/csrc/gated_filter.cu",
        "replaces": "metran_tpu/ops/implicit_map.py:260",
    },
    "sqrt_filter_robust": {
        "source": "metran_tpu_torch/kernels/csrc/sqrt_filter.cu",
        "replaces": "metran_tpu/ops/implicit_map.py:358",
    },
    "steady_filter": {
        "source": "metran_tpu_torch/kernels/csrc/steady_filter.cu",
        "replaces": "metran_tpu/ops/kalman.py:1362",
    },
    "dare": {
        "source": "metran_tpu_torch/kernels/csrc/dare.cu",
        "replaces": "metran_tpu/ops/kalman.py:1155",
    },
    "arena_update": {
        "source": "metran_tpu_torch/kernels/csrc/arena_gated.cu",
        "replaces": "metran_tpu/serve/engine.py:1042",
        # the joint family counts under the same name
        "sources": ["metran_tpu_torch/kernels/csrc/arena_gated.cu",
                    "metran_tpu_torch/kernels/csrc/arena_joint.cu"],
    },
    "arena_update_sqrt": {
        "source": "metran_tpu_torch/kernels/csrc/arena_sqrt.cu",
        "replaces": "metran_tpu/serve/engine.py:1042",
    },
    "arena_steady_update": {
        "source": "metran_tpu_torch/kernels/csrc/arena_steady.cu",
        "replaces": "metran_tpu/serve/engine.py:1337",
    },
    "arena_forecast": {
        "source": "metran_tpu_torch/kernels/csrc/arena_forecast.cu",
        "replaces": "metran_tpu/serve/engine.py:1473",
    },
    "parallel_filter": {
        "source": "metran_tpu_torch/kernels/csrc/pkalman_filter.cu",
        "replaces": "metran_tpu/ops/pkalman.py:317",
    },
    "parallel_smooth": {
        "source": "metran_tpu_torch/kernels/csrc/pkalman_smoother.cu",
        "replaces": "metran_tpu/ops/pkalman.py:401",
    },
    "sqrt_parallel_filter": {
        "source": "metran_tpu_torch/kernels/csrc/sqrt_pkalman_filter.cu",
        "replaces": "metran_tpu/ops/pkalman.py:613",
    },
    "sqrt_parallel_smooth": {
        "source": "metran_tpu_torch/kernels/csrc/sqrt_pkalman_smoother.cu",
        "replaces": "metran_tpu/ops/pkalman.py:704",
    },
    **{f"{base}_{mode}": {
        "source": f"metran_tpu_torch/kernels/csrc/{src}.cu",
        "replaces": f"metran_tpu/ops/pkalman.py:{line}"}
       for base, src in (("parallel_filter", "pkalman_filter"),
                         ("parallel_smooth", "pkalman_smoother"))
       for mode, line in (("total", 784), ("carry", 790), ("prefix", 804))},
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

    smi = timed(phase_device)
    timed(phase_build)
    checks, times = timed(phase_kernels)
    for phase in (phase_k1_kernels, phase_lanes_kernels, phase_k3_kernels,
                  phase_k4_kernels,
                  phase_products_kernels,
                  phase_single_kernels, phase_sqrt_kernels,
                  phase_adjoint_kernels, phase_gate_kernels,
                  phase_robust_kernels, phase_steady_kernels,
                  phase_arena_kernels, phase_readpath_kernels,
                  phase_pkalman_kernels, phase_sharded_scan_kernels):
        more_checks, more_times = timed(phase)
        checks += more_checks
        times.update(more_times)
    timed(phase_sqrt_precision)
    from metran_tpu_torch.kernels.build import oracle_launches

    oracle0 = oracle_launches()  # the paths' phases start here
    paths, medians = {}, {}
    for engine, path in (("joint", "serve"), ("sqrt", "serve_sqrt")):
        paths[path], medians[engine] = timed(phase_main_path, engine)
    emit({"phase": "serve_engines", "dispatch_medians": medians})
    gated = {}
    for engine in ("joint", "sequential", "sqrt"):
        paths[f"gated_{engine}"], gated[engine] = timed(
            phase_gated_serving, engine)
    for policy in ("huber", "inflate"):
        paths[f"gated_joint_{policy}"], gated[f"joint_{policy}"] = timed(
            phase_gated_serving, "joint", policy, rounds=6, sync=False)
    emit({"phase": "gated_engines", "timings": gated})
    robust = {}
    for engine, likelihood, kw in (
            ("joint", "censored", dict(sync=True, detect=True)),
            ("sqrt", "censored", {}),
            ("joint", "huber_t", dict(rounds=6)),
            ("sqrt", "quantized", dict(rounds=6))):
        key = f"{engine}_{likelihood}"
        paths[f"robust_{key}"], robust[key] = timed(
            phase_robust_serving, engine, likelihood, **kw)
    emit({"phase": "robust_engines", "timings": robust,
          "gated_timings": gated})
    paths["steady_serving"], steady = timed(phase_steady_serving)
    paths["fixed_lag"] = timed(phase_fixed_lag)
    emit({"phase": "steady_engines", "dispatch_ms": steady})
    paths["arena_serving"], _ = timed(phase_arena_serving)
    paths["readpath"] = timed(phase_readpath)
    # worker processes for the CPU f64 recomputes of phases 5 and 7 (the
    # fleet stderr's run through phases 6 and 7, checked last)
    with ProcessPoolExecutor(
            max_workers=4,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        fit = timed(phase_fit_path, pool)
        paths["fit"] = fit["counts"]
        paths["mesh"] = timed(phase_mesh_path, fit)
        paths["batch_fit"] = timed(phase_batch_fit, pool, fit)
        paths["products"] = timed(phase_products_path, fit)
        paths["metran"], mt64, out64 = timed(phase_metran_path, pool)
        paths["parallel"] = timed(phase_parallel_path, pool, mt64, out64)
        timed(check_stderr, fit)
    paths["c2_defaults"] = timed(phase_c2_defaults, mt64)

    # nothing on a path chooses K1's or K9's block kernel or K3's or K4's
    # warp kernel
    oracle = {k: v - oracle0[k] for k, v in oracle_launches().items()}
    require(not any(oracle.values()),
            f"the paths launched a block kernel (an oracle): {oracle}")
    summary = []
    for name, meta in KERNELS.items():
        t = times[name]
        f32 = [c["max_abs_err"] for c in checks
               if c["kernel"] == name and c["dtype"] == "float32"]
        by_path = {path: c[name] for path, c in paths.items()
                   if c.get(name)}  # the oracle: in no path's counts
        entry = {
            "name": name, "route": "cuda", **meta,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(f32),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": t["shape"],
        }
        if "plain_shape" in t:
            entry["plain_shape"] = t["plain_shape"]
        if name == "joint_filter_append":
            entry["history_pass"] = times["joint_filter_append_history"]
            entry["bounds"] = times["joint_filter_append_bounds"]
            entry["warp_vs_block"] = times["k1_warp_vs_block"]
        if name in ("joint_filter_append_block", "sqrt_filter_block",
                    "lanes_adjoint_warp", "lanes_filter_warp"):
            entry["bounds_by_batch"] = t["bounds_by_batch"]
        if name == "lanes_adjoint":
            entry["ring_vs_warp"] = times["k4_ring_vs_warp"]
        if name == "sqrt_filter":
            entry["group_vs_block"] = times["k9_group_vs_block"]
        if name == "lanes_filter":
            entry["vg_launch"] = t["vg_launch"]
            entry["chain_vs_warp"] = times["k3_chain_vs_warp"]
        if name == "joint_adjoint":
            for key in ("by_batch", "ring_depth", "blocks_per_sm"):
                entry[key] = t[key]
        # another kernel's name that extends this one's owns its keys
        longer = [o for o in KERNELS if o.startswith(name + "_")]
        others = {k: v for k, v in times.items()
                  if k.startswith(name + "_") and k not in KERNELS
                  and not any(k.startswith(o + "_") for o in longer)}
        if name != "joint_filter_append" and others:
            entry["other_launches"] = others
        summary.append(entry)
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
