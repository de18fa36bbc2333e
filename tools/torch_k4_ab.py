#!/usr/bin/env python3
"""Kernel K4 (the lanes fit's closed-form adjoint) on one CUDA card: the
ring kernel (``csrc/lanes_adjoint.cu``: replay warps fill a ring of
segment records, one or two sweep warps run back over them) against the warp
kernel it replaced (``csrc/lanes_adjoint_warp.cu``: one warp a lane,
replaying and sweeping in turn), both built from this checkout and run
in one process.

Usage, from the root of a checkout::

    python3 tools/torch_k4_ab.py [--jobs phases-old,phases-new,times,shapes,wide,fit]

Jobs (default: all six):

- ``phases-old``, ``phases-new``: a copy of the kernel's source patched
  with ``clock64()`` stamps at its phases is built into
  ``kernels/build/k4_phases/`` (the sources in ``csrc/`` are not
  touched).  A recording thread adds the cycles from one stamp to the
  next to its phase.  The warp kernel (lane 0 of each lane's warp): the
  replay's boundary load, its predict (the record copy, the step's data
  and the predict) and its slots (the updates and their record writes);
  the sweep's head loads (sb, db, the mask and y), its per-slot record
  loads, S d and S' d, the sums and scalars, the S and u update, and the
  predict adjoint with its cov0 reload.  The ring kernel: lane 0 of the
  sweep's row warp (its waits on the ring and the copies, S d with the
  column warp's S' d beside it, the sums, the update, the predict
  adjoint, the rest: the ``// phase:`` comments of its source) and lane
  0 of replay warp 0 (its waits and boundary loads, its replayed
  steps).  Run at the
  flagship shape ((20, 21) f32, T = 5,000, seg = 100) at B = 512 and
  B = 1; prints each phase's cycles a step (mean over lanes), its share,
  and that share of the unstamped kernel's CUDA-event time a step.
- ``times``: ``chip_smoke.k4_times`` with three timed launches a turn:
  the two kernels alternating (warp, ring, ring, warp) at B = 512, 64, 8
  and 1, T = 5,000, seg = 100, (20, 21) f32, each pair held bit for
  bit, beside ``chip_smoke.k4_cost``'s bound.
- ``shapes``: the ring kernel with four replay warps forced over five
  slots and over four, with two sweep warps and with one (two staged
  records), alternating (each shape, then in reverse), at B = 512, 64, 8
  and 1 in f32 and B = 512 and 1 in f64, T = 5,000, seg = 100, beside
  the warp kernel, each held to it with ``torch.equal``.
- ``wide``: B = 1,024, 2,048 and 4,096 at T = 1,000, f32 and f64: the
  warp kernel and the ring kernel at each (replay warps, sweep warps,
  staged records) of ``WIDE_SHAPES`` and at ``ring_geometry``'s
  choice, each held to the warp kernel with ``torch.equal``, beside the
  lanes the card keeps resident and the ring's bytes.
- ``fit``: the 512-model ``fit_fleet(layout="lanes")`` of
  ``chip_smoke.py``'s phase 5 and the flagship ``Metran(series).solve()``
  of its phase 7, each run with K4 on the ring kernel, then routed to the
  warp kernel: walls, K4's share, iterations, parameters and deviances,
  and whether they agree bit for bit.

Prints JSON lines and the card's ``nvidia-smi`` name and power limit.
Needs a card; imports no JAX.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

PHASES = ("wait", "S d and S' d", "sums and scalars", "S and u update",
          "predict adjoint", "rest", "head loads", "slot record loads",
          "replay boundary and waits", "replay predict", "replay slots",
          "end")
NEW_ANCHORS = {"wait": 0, "sd": 1, "sums": 2, "update": 3, "predict": 4,
               "rest": 5, "replay-wait": 8, "replay-step": 9}
# the wide job's forced shapes: (replay warps, sweep warps, staged
# records), each over R + 1 slots
WIDE_SHAPES = ((1, 1, 2), (2, 1, 2), (1, 1, 1), (2, 1, 1), (1, 1, 0),
               (2, 2, 2))
# lanes_adjoint_warp.cu's lines that open each phase (the stamp goes
# before the line, or after it with a negative index)
OLD_ANCHORS = (
    ("    // ---- replay the segment from its boundary, keeping residuals\n",
     8),
    ("      const int t = g * seg + k;\n      T* res = scr + (size_t)k * "
     "stride;\n", 9),
    ("      const T* res = scr + (size_t)k * stride;\n", -6),
    ("        const T* zi = Zs + i * n;\n", 7),
    ("        T ud_p = 0, dsd_p = 0;\n", 1),
    ("        const T ud = warp_sum(ud_p);\n", 2),
    ("        __syncwarp();  // every column of S read before rows are "
     "rewritten\n", -3),
    ("      // predict adjoint: (u, S) are the adjoints of the predicted "
     "moments;\n", 4),
)
FILTER_CALL = ("      lanes::filter_step(P, m, kv, Zs, ph, qd, rs, ys, ms, N, "
               "n, lane, sig,\n                         det, res);\n")
FILTER_SPLIT = ("      lanes::predict(P, m, ph, qd, n, lane);\n"
                "      K4_STAMP(10);\n"
                "      lanes::update_step(P, m, kv, Zs, rs, ys, ms, N, n, "
                "lane, sig, det,\n                         res);\n")
MAX_LANES = 4096
N_PHASES = len(PHASES)
PRELUDE = f"""#include <cuda_runtime.h>
__device__ unsigned long long k4_phase[{MAX_LANES} * {N_PHASES}];
#define K4_STAMP(i)                         \\
  do {{                                      \\
    if (k4_rec) {{                           \\
      const long long now = clock64();      \\
      k4_acc[k4_cur] += now - k4_last;      \\
      k4_last = now;                        \\
      k4_cur = (i);                         \\
    }}                                       \\
  }} while (0)
"""
DECLS = ("  long long k4_acc[{n}] = {{0}};\n"
         "  long long k4_last = clock64();\n  int k4_cur = {cur};\n"
         "  const bool k4_rec = {rec};\n")
FLUSH = ("  K4_STAMP({end});\n  if (k4_rec && {lane} < {max_lanes})\n"
         "    for (int i = 0; i < {n}; ++i)\n"
         "      atomicAdd(&k4_phase[(size_t)({lane}) * {n} + i],\n"
         "                (unsigned long long)k4_acc[i]);\n")
READ = f"""
extern "C" int k4_phase_read(void* dst, int n) {{
  return (int)cudaMemcpyFromSymbol(dst, k4_phase,
                                   (size_t)n * {N_PHASES} * 8);
}}
extern "C" int k4_phase_clear() {{
  static unsigned long long zero[{MAX_LANES} * {N_PHASES}];
  return (int)cudaMemcpyToSymbol(k4_phase, zero, sizeof(zero));
}}
"""


def _patch_old(text):
    for line, i in OLD_ANCHORS:
        assert text.count(line) == 1, line
        stamp = f"    K4_STAMP({abs(i)});\n"
        text = text.replace(line, line + stamp if i < 0 else stamp + line)
    assert text.count(FILTER_CALL) == 1
    text = text.replace(FILTER_CALL, FILTER_SPLIT)
    head = "  if (l >= L) return;  // warp-uniform; no block-wide barrier follows\n"
    assert text.count(head) == 1
    text = text.replace(head, head + DECLS.format(n=N_PHASES, cur=5,
                                                  rec="lane == 0"))
    # the sweep step's last statement closes "rest"; the outputs flush
    tail = "  for (int a = lane; a < n; a += 32) {\n    phibar[(size_t)a"
    assert text.count(tail) == 1
    return text.replace(tail, FLUSH.format(
        end=N_PHASES - 1, lane="l", max_lanes=MAX_LANES, n=N_PHASES) + tail)


def _patch_new(text):
    out = []
    for line in text.splitlines(keepends=True):
        m = re.match(r"\s*// phase: ([\w-]+)", line)
        if m:
            out.append(f"    K4_STAMP({NEW_ANCHORS[m.group(1)]});\n")
        out.append(line)
    text = "".join(out)
    head = "  // the stamps' declarations\n"
    tail = "  // the stamps' flush\n"
    assert text.count(head) == 2 and text.count(tail) == 2
    # the replay (warp 0's lane 0) first, then the sweep (the row warp's
    # lane 0)
    first, rest = text.split(head, 1)
    text = (first + head + DECLS.format(n=N_PHASES, cur=8,
                                        rec="w == 0 && lane == 0")
            + rest.replace(head, head + DECLS.format(
                n=N_PHASES, cur=5, rec="role == 0 && lane == 0")))
    return text.replace(tail, tail + FLUSH.format(
        end=N_PHASES - 1, lane="blockIdx.x", max_lanes=MAX_LANES,
        n=N_PHASES))


def phase_library(kind):
    """Build the stamped copy of K4's source of ``kind`` (``"old"``: the
    warp kernel, ``lanes_adjoint_warp.cu``; ``"new"``: the ring kernel,
    ``lanes_adjoint.cu``); returns its library stem and the library
    loaded, with the entry points' argument types set."""
    from metran_tpu_torch.kernels import build

    stem = "lanes_adjoint_warp" if kind == "old" else "lanes_adjoint"
    out = build.BUILD_DIR / "k4_phases"
    out.mkdir(parents=True, exist_ok=True)
    for hdr in build.CSRC.glob("*.cuh"):
        (out / hdr.name).write_text(hdr.read_text())
    text = (build.CSRC / f"{stem}.cu").read_text()
    text = _patch_old(text) if kind == "old" else _patch_new(text)
    (out / f"{stem}.cu").write_text(PRELUDE + text + READ)
    lib_path = out / f"lib{stem}_phases.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                           str(out / f"{stem}.cu"), "-o", str(lib_path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    entries = build._SIGNATURES[stem]
    if isinstance(entries[0], str):
        entries = (entries,)
    for base, argtypes in entries:
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.metran_error_string.argtypes = [ctypes.c_int]
    lib.metran_error_string.restype = ctypes.c_char_p
    lib.k4_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return stem, lib


def adjoint_args(b, t, dtype=None, seg=100):
    """K4's arguments at the flagship shape: ``chip_smoke._k4_case`` for
    min(b, 512) data lanes over ``t`` steps, b // 512 trial lanes a data
    lane past 512 (the line search's layout), K3's boundaries every
    ``seg`` steps and the deviance's cotangents."""
    import numpy as np
    import torch

    import chip_smoke as cs

    return cs._k4_case(np.random.default_rng(cs.SEED + 21),
                       min(b, cs.FLEET), t, seg, dtype or torch.float32,
                       torch.device("cuda"), deviance=True,
                       trials=max(1, b // cs.FLEET))


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def _equal(x, y):
    """``torch.equal`` with NaN in the same places."""
    import torch

    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    nx, ny = torch.isnan(x), torch.isnan(y)
    return bool(torch.equal(nx, ny)) and bool(torch.equal(x[~nx], y[~ny]))


def job_phases(kind, smi, rings=(None,)):
    import torch

    import chip_smoke as cs
    from metran_tpu_torch.kernels import build
    from metran_tpu_torch.kernels import lanes as kl

    stem, stamped = phase_library(kind)
    real = build.load_library(stem)
    run = {"old": kl.lanes_adjoint_warp_kernel,
           "new": kl.lanes_adjoint_kernel}[kind]
    seg = 100
    chooser = kl.ring_geometry
    for b, forced in ((b, r) for b in (cs.FLEET, 1) for r in rings):
        adj, _ = adjoint_args(b, cs.T_STEPS, seg=seg)
        if forced is not None:  # R replay warps over R + 1 slots
            kl.ring_geometry = lambda *a, r=forced: kl.RingShape(
                r, r + 1, kl.SWEEP_WARPS, 2)
        try:
            ms, want = cs.cuda_ms(lambda: run(*adj), reps=3, warm=1)
            entry = _phases_entry(kind, stem, stamped, real, run, adj, b,
                                  seg, ms, want, smi)
        finally:
            kl.ring_geometry = chooser
        print(json.dumps(entry), flush=True)


def _phases_entry(kind, stem, stamped, real, run, adj, b, seg, ms, want,
                  smi):
    """One phases line: the stamped copy run once on ``adj``."""
    import torch

    import chip_smoke as cs
    from metran_tpu_torch.kernels import build
    from metran_tpu_torch.kernels import lanes as kl

    build._libs[stem] = stamped
    try:
        stamped.k4_phase_clear()
        ms_stamped, got = cs.cuda_ms(lambda: run(*adj), reps=1, warm=0)
        raw = torch.zeros(MAX_LANES * N_PHASES, dtype=torch.int64)
        err = stamped.k4_phase_read(raw.data_ptr(), MAX_LANES)
        require(err == 0, f"k4_phase_read: CUDA error {err}")
    finally:
        build._libs[stem] = real
    steps = -(-cs.T_STEPS // seg) * seg
    cyc = raw.view(MAX_LANES, N_PHASES)[:b].double().mean(0)
    entry = {"job": f"phases-{kind}", "B": b,
             "shape": f"(20,21) f32 T={cs.T_STEPS} seg={seg}",
             "ms": ms, "ms_stamped": ms_stamped,
             "us_per_step": ms * 1e3 / steps,
             "bitwise_stamped": all(_equal(g, w)
                                    for g, w in zip(got, want)),
             "card": smi}
    if kind == "old":
        per = cyc / steps
        share = per / per.sum()
        entry["cycles_per_step"] = float(per.sum())
        entry["phases"] = {
            name: {"cycles": float(c), "share": float(s),
                   "us": float(s) * ms * 1e3 / steps}
            for name, c, s in zip(PHASES, per, share) if c > 0}
    else:
        ring, depth, sweep_warps, stages = kl.ring_geometry(
            b, cs.T_STEPS, seg, cs.N_SERIES, cs.N_SERIES + 1,
            torch.float32, torch.device("cuda"))
        n_seg = -(-cs.T_STEPS // seg)
        replayed = len(range(0, n_seg, ring)) * seg  # by replay warp 0
        sweep = {PHASES[k]: float(cyc[k] / steps) for k in range(6)
                 if cyc[k] > 0}
        total = sum(sweep.values())
        replay = {PHASES[k]: float(cyc[k] / replayed) for k in (8, 9)}
        entry.update({
            "ring": ring, "depth": depth, "sweep_warps": sweep_warps,
            "stages": stages,
            "sweep_cycles_per_step": total,
            "sweep": {k: {"cycles": c, "share": c / total}
                      for k, c in sweep.items()},
            "replay_cycles_per_replayed_step": sum(replay.values()),
            "replay": replay})
    return entry


def job_times(smi):
    import chip_smoke as cs
    from metran_tpu_torch.kernels import lanes as kl

    for key, entry in cs.k4_times(kl, cs.DEVICE, reps=3).items():
        print(json.dumps({"job": "times", "case": key,
                          "shape": f"(20,21) f32 T={cs.T_STEPS} "
                                   f"seg={cs.K4_SEG}", **entry,
                          "card": smi}), flush=True)
        require(entry["bitwise"], f"{key}: ring and warp kernels differ")


def job_shapes(smi):
    import torch

    import chip_smoke as cs
    from metran_tpu_torch.kernels import lanes as kl

    shapes = {"R4 D5 S2": (4, 5, 2), "R4 D5 S1": (4, 5, 1),
              "R4 D4 S2": (4, 4, 2), "R4 D4 S1": (4, 4, 1)}
    chooser = kl.ring_geometry
    for dtype, batches in ((torch.float32, (cs.FLEET, 64, 8, 1)),
                           (torch.float64, (cs.FLEET, 1))):
        for b in batches:
            adj, _ = adjoint_args(b, cs.T_STEPS, dtype)
            _, want = cs.cuda_ms(lambda: kl.lanes_adjoint_warp_kernel(*adj),
                                 reps=1, warm=0)
            ms, same = {key: [] for key in shapes}, {}
            for key in list(shapes) + list(reversed(shapes)):
                ring, depth, sweep = shapes[key]
                kl.ring_geometry = lambda *a, sh=kl.RingShape(
                    ring, depth, sweep, 2): sh
                try:
                    t, got = cs.cuda_ms(lambda: kl.lanes_adjoint_kernel(*adj),
                                        reps=3, warm=1)
                finally:
                    kl.ring_geometry = chooser
                ms[key].append(t)
                same[key] = all(_equal(g, w) for g, w in zip(got, want))
            warp_ms, _ = cs.cuda_ms(
                lambda: kl.lanes_adjoint_warp_kernel(*adj), reps=1, warm=0)
            print(json.dumps({
                "job": "shapes", "B": b,
                "dtype": str(dtype).replace("torch.", ""),
                "shape": f"(20,21) T={cs.T_STEPS} seg=100", "ms": ms,
                "warp_ms": warp_ms, "bitwise": same, "card": smi}),
                flush=True)
            require(all(same.values()), f"B={b} {dtype}: {same}")


def job_wide(smi):
    import torch

    import chip_smoke as cs
    from metran_tpu_torch.kernels import lanes as kl

    t, seg = 1_000, 100
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chooser = kl.ring_geometry
    for dtype in (torch.float32, torch.float64):
        for b in (1_024, 2_048, 4_096):
            adj, _ = adjoint_args(b, t, dtype, seg=seg)
            chosen = chooser(b, t, seg, cs.N_SERIES, cs.N_SERIES + 1, dtype,
                             torch.device("cuda"))
            ms = {}
            ms["oracle"], want = cs.cuda_ms(
                lambda: kl.lanes_adjoint_warp_kernel(*adj), reps=3, warm=1)
            same, resident = {}, {}
            try:
                for ring, sweep, stages in WIDE_SHAPES:
                    shape = kl.RingShape(ring, ring + 1, sweep, stages)
                    kl.ring_geometry = lambda *a, sh=shape: sh
                    key = f"R={ring} S={sweep} stages={stages}"
                    ms[key], got = cs.cuda_ms(
                        lambda: kl.lanes_adjoint_kernel(*adj), reps=3,
                        warm=1)
                    same[key] = all(_equal(g, w) for g, w in zip(got, want))
                    resident[key] = sms * kl.adjoint_occupancy(
                        cs.N_SERIES, cs.N_SERIES + 1, dtype, ring, stages,
                        sweep)
            finally:
                kl.ring_geometry = chooser
            ms["chosen"], got = cs.cuda_ms(
                lambda: kl.lanes_adjoint_kernel(*adj), reps=3, warm=1)
            same["chosen"] = all(_equal(g, w) for g, w in zip(got, want))
            print(json.dumps({
                "job": "wide", "case": f"B={b} T={t} (20,21) seg={seg}",
                "dtype": str(dtype).replace("torch.", ""), "ms": ms,
                "speedup": ms["oracle"] / ms["chosen"],
                "chosen": list(chosen), "bitwise": same,
                "resident_lanes": resident,
                "ring_bytes": kl.ring_bytes(b, seg, cs.N_SERIES,
                                            cs.N_SERIES + 1, dtype,
                                            chosen.depth),
                "card": smi}), flush=True)
            require(all(same.values()), f"B={b} {dtype}: ring and warp "
                    f"kernels differ: {same}")


def job_fit(smi):
    import numpy as np
    import torch

    import chip_smoke as cs
    from metran_tpu_torch.data import Panel
    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.kernels import lanes as kl
    from metran_tpu_torch.kernels.build import oracle_launches
    from metran_tpu_torch import Metran
    from metran_tpu_torch.parallel import (autocorr_init_params, fit_fleet,
                                           pack_fleet)

    rng = np.random.default_rng(cs.SEED + 30)  # phase 5's fleet
    y, mask, lds, _, _ = cs.make_workload(rng, cs.FLEET, t=cs.T_STEPS)
    names = [f"s{j}" for j in range(cs.N_SERIES)]
    y32 = y.astype(np.float32)
    fleet = pack_fleet([Panel(y32[i], mask[i], None, names,
                              np.ones(cs.N_SERIES), np.zeros(cs.N_SERIES),
                              1.0) for i in range(cs.FLEET)], list(lds),
                       dtype=torch.float32, device=torch.device("cuda"))
    p0 = autocorr_init_params(fleet)
    ring_kernel = kl.lanes_adjoint_kernel
    k4 = {"lanes_adjoint_kernel"}

    def routed(route, run):
        if route == "oracle":
            kl.lanes_adjoint_kernel = kl.lanes_adjoint_warp_kernel
        try:
            reset_launches()
            before = oracle_launches()
            with cs._KernelTimer() as timer:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                k4_ms = timer.kernel_ms(names=k4)
                k_ms = timer.kernel_ms()
            after = oracle_launches()
        finally:
            kl.lanes_adjoint_kernel = ring_kernel
        return out, {"k4": route, "wall_s": wall, "k4_ms": k4_ms,
                     "k4_share": k4_ms / 1e3 / wall, "kernel_ms": k_ms,
                     "launches": {k: v for k, v in launches().items() if v},
                     "oracle_launches": {k: after[k] - before[k]
                                         for k in after
                                         if after[k] != before[k]}}

    fits = {}
    for route in ("ring", "oracle"):
        fit, info = routed(route, lambda: fit_fleet(fleet, p0=p0, **cs.FIT))
        fits[route] = fit
        print(json.dumps({
            "job": "fit", "case": f"lanes fit, {cs.FLEET} models", **info,
            "fits_per_s": cs.FLEET / info["wall_s"],
            "iterations_mean": float(fit.iterations.float().mean()),
            "iterations_max": int(fit.iterations.max()),
            "deviance_mean": float(fit.deviance.double().mean()),
            "card": smi}), flush=True)
    a, b = fits["ring"], fits["oracle"]
    same = {key: bool(torch.equal(getattr(a, key), getattr(b, key)))
            for key in ("params", "deviance", "iterations", "converged")}
    print(json.dumps({"job": "fit", "case": "lanes fit", "bitwise": same,
                      "card": smi}), flush=True)
    require(all(same.values()), f"the two lanes fits differ: {same}")

    solved = {}
    for route in ("ring", "oracle"):
        mt = Metran(cs.flagship_series(cs.SEED + 70), name="flagship")
        _, info = routed(route, lambda: mt.solve(report=False))
        solved[route] = mt
        print(json.dumps({
            "job": "fit", "case": "flagship Metran.solve()", **info,
            "iterations": int(mt.fit.fleet_fit.iterations[0]),
            "nfev": int(mt.fit.nfev), "obj_func": mt.fit.obj_func,
            "card": smi}), flush=True)
    a, b = solved["ring"], solved["oracle"]
    same = {
        "optimal": bool(np.array_equal(
            a.parameters["optimal"].values, b.parameters["optimal"].values)),
        "stderr": bool(np.array_equal(
            a.parameters["stderr"].values, b.parameters["stderr"].values,
            equal_nan=True)),
        "obj_func": a.fit.obj_func == b.fit.obj_func,
        "iterations": bool(torch.equal(a.fit.fleet_fit.iterations,
                                       b.fit.fleet_fit.iterations)),
        "nfev": a.fit.nfev == b.fit.nfev}
    print(json.dumps({"job": "fit", "case": "flagship Metran.solve()",
                      "bitwise": same, "card": smi}), flush=True)
    require(all(same.values()), f"the two solves differ: {same}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs",
                    default="phases-old,phases-new,times,shapes,wide,fit")
    ap.add_argument("--rings", default="",
                    help="phases-new at these forced replay warps "
                         "(comma-separated; default ring_geometry's)")
    args = ap.parse_args()
    jobs = args.jobs.split(",")
    rings = tuple(int(r) for r in args.rings.split(",") if r) or (None,)
    import torch

    from metran_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("torch_k4_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    if "fit" not in jobs:  # only K3 and the K4 kernels the jobs run
        stems = ["lanes_filter"]
        if jobs != ["phases-new"]:
            stems.append("lanes_adjoint_warp")
        if jobs != ["phases-old"]:
            stems.append("lanes_adjoint")
        build.sources = lambda: [build.CSRC / f"{s}.cu" for s in stems]
    t0 = time.perf_counter()
    build.build()
    ptxas = {src: [line.strip() for line in text.splitlines()
                   if "Used" in line or "spill" in line][:12]
             for src, text in build.build_info.get("ptxas", {}).items()
             if src.startswith("lanes_adjoint")}
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "ptxas": ptxas}), flush=True)
    for job in jobs:
        if job.startswith("phases-"):
            kind = job.removeprefix("phases-")
            job_phases(kind, smi, rings if kind == "new" else (None,))
        elif job == "times":
            job_times(smi)
        elif job == "shapes":
            job_shapes(smi)
        elif job == "wide":
            job_wide(smi)
        elif job == "fit":
            job_fit(smi)
        else:
            raise SystemExit(f"unknown job {job}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
