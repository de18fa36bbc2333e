#!/usr/bin/env python3
"""Kernel K3 (the lanes fit's forward filter) on one CUDA card: the chain
kernel (``csrc/lanes_filter.cu``: a block per lane, a chain warp that
runs each observed slot on z_i's nonzero columns and update warps that
apply the rest of each rank-1 update and the predicts a slot behind)
against the warp kernel it replaced (``csrc/lanes_filter_warp.cu``: one
warp a lane, every step by ``lanes::filter_step``), both built from this
checkout and run in one process.

Usage, from the root of a checkout::

    python3 tools/torch_k3_ab.py [--jobs phases-old,phases-new,times,wide,fit]

Jobs (default: all five):

- ``phases-old``, ``phases-new``: a copy of the kernel's source (and of
  the headers it includes) patched with ``clock64()`` stamps at its
  phases is built into ``kernels/build/k3_phases/`` (the sources in
  ``csrc/`` are not touched).  Lane 0 of the recording warp adds the
  cycles from one stamp to the next to its phase.  The warp kernel: a
  step's ``load_step``, its predict, per observed slot ``z_i.m`` with its
  butterfly, ``P z_i``, the f butterfly, the divisions, the m and P
  update and sigma/log f, and the boundary copy-out.  The chain kernel:
  the chain warp's phases, at the ``// phase:`` comments of its header.
  Run at the trial pass (K = 4 trial lanes over each of 512 data lanes,
  no boundaries), at B = 512 with boundaries and at B = 1, (20, 21) f32,
  T = 5,000, seg = 100; prints each phase's cycles a step (mean over
  lanes), a slot's where the phase is a slot's, its share, and that
  share of the unstamped kernel's CUDA-event time a step.
- ``times``: ``chip_smoke.k3_times``: the two kernels alternating (warp,
  chain, chain, warp) at the trial pass and at B = 512, 64, 8 and 1 with
  boundaries, T = 5,000, seg = 100, (20, 21) f32, each pair held bit for
  bit, beside ``chip_smoke.k3_cost``'s bound.
- ``wide``: B = 1,024, 2,048 and 4,096 at T = 1,000, f32 and f64, with
  boundaries: the warp kernel and the chain kernel at each count of
  update warps (``UPDATE_WARPS``) and at ``chain_shape``'s choice, each
  held to the warp kernel with ``torch.equal``, beside the lanes the
  card keeps resident.
- ``fit``: the 512-model ``fit_fleet(layout="lanes")`` of
  ``chip_smoke.py``'s phase 5, the flagship ``Metran(series).solve()`` of
  its phase 7 and ``fleet_stderr(method="lanes-fd")`` of the fitted
  fleet, each run with K3 on the chain kernel, then routed to the warp
  kernel: walls, K3's share, iterations, parameters, deviances and
  standard errors, and whether they agree bit for bit.

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

OLD_PHASES = ("load_step", "predict", "z_i.m and butterfly", "P z_i",
              "f butterfly", "divisions", "m and P update", "sigma, log f",
              "boundary copy-out", "rest", "end")
# the phases of a slot (their cycles are also given per observed slot)
OLD_SLOT = (2, 3, 4, 5, 6, 7)
# lanes_step.cuh's lines that open each phase: (line, phase, the stamp
# before the line or after it)
OLD_STEP_ANCHORS = (
    ("                                          int t_steps, int N, int "
     "lane) {\n", 0, "after"),
    ("                                        int n, int lane) {\n", 1,
     "after"),
    ("                                              T& v_out, T& f_out, T* "
     "d_res) {\n", 2, "after"),
    ("  T fpart = 0;\n", 3, "before"),
    ("  const T f = warp_sum(fpart) + ri;\n", 4, "before"),
    ("  for (int a = lane; a < n; a += 32) kv[a] = kv[a] / f;\n", 5,
     "before"),
    ("  for (int a = lane; a < n; a += 32) kv[a] = kv[a] / f;\n", 6,
     "after"),
    ("    sig = sig + v * v / f;\n", 7, "before"),
    ("    det = det + log(f);\n", 9, "after"),
)
# lanes_filter_warp.cu's lines
OLD_KERNEL_ANCHORS = (
    ("    if (bmean != nullptr && t % seg == 0) {\n", 8, "after"),
    ("      __syncwarp();  // the copy reads rows that predict rewrites\n", 9,
     "after"),
)
NEW_PHASES = ("wait", "v", "d and f", "gain", "publish", "look ahead",
              "step", "predict", "full", "rest", "end")
NEW_SLOT = (0, 1, 2, 3, 4, 5)
MAX_LANES = 4096
PRELUDE = """#include <cuda_runtime.h>
__device__ unsigned long long k3_phase[{max_lanes} * {n}];
// the recording warps' cycles (lane 0 of each warp of a block)
__shared__ long long k3_acc[{warps} * {n}];
__shared__ long long k3_last[{warps}];
__shared__ int k3_cur[{warps}];
#define K3_STAMP(i)                                                  \\
  do {{                                                               \\
    if ((threadIdx.x & 31) == 0) {{                                   \\
      const int w_ = threadIdx.x >> 5;                               \\
      const long long now_ = clock64();                              \\
      k3_acc[w_ * {n} + k3_cur[w_]] += now_ - k3_last[w_];           \\
      k3_last[w_] = now_;                                            \\
      k3_cur[w_] = (i);                                              \\
    }}                                                                \\
  }} while (0)
#define K3_BEGIN(start)                                              \\
  do {{                                                               \\
    if ((threadIdx.x & 31) == 0) {{                                   \\
      const int w_ = threadIdx.x >> 5;                               \\
      for (int i_ = 0; i_ < {n}; ++i_) k3_acc[w_ * {n} + i_] = 0;    \\
      k3_cur[w_] = (start);                                          \\
      k3_last[w_] = clock64();                                       \\
    }}                                                                \\
  }} while (0)
#define K3_FLUSH(lane_index)                                         \\
  do {{                                                               \\
    K3_STAMP({end});                                                 \\
    if ((threadIdx.x & 31) == 0 && (lane_index) < {max_lanes}) {{     \\
      const int w_ = threadIdx.x >> 5;                               \\
      for (int i_ = 0; i_ < {n}; ++i_)                               \\
        atomicAdd(&k3_phase[(size_t)(lane_index) * {n} + i_],        \\
                  (unsigned long long)k3_acc[w_ * {n} + i_]);        \\
    }}                                                                \\
  }} while (0)
"""
READ = """
extern "C" int k3_phase_read(void* dst, int n) {{
  return (int)cudaMemcpyFromSymbol(dst, k3_phase, (size_t)n * {n} * 8);
}}
extern "C" int k3_phase_clear() {{
  static unsigned long long zero[{max_lanes} * {n}];
  return (int)cudaMemcpyToSymbol(k3_phase, zero, sizeof(zero));
}}
"""


def _stamp(text, anchors):
    for line, phase, where in anchors:
        assert text.count(line) == 1, line
        stamp = f"  K3_STAMP({phase});\n"
        text = text.replace(line, stamp + line if where == "before"
                            else line + stamp)
    return text


def _patch_old(text, step):
    """The warp kernel's source and lanes_step.cuh, stamped."""
    step = _stamp(step, OLD_STEP_ANCHORS)
    text = _stamp(text, OLD_KERNEL_ANCHORS)
    head = ("  if (l >= L) return;  // warp-uniform; no block-wide barrier "
            "follows\n")
    assert text.count(head) == 1
    text = text.replace(head, head + "  K3_BEGIN(9);\n")
    tail = "  for (int a = lane; a < n; a += 32) mean_out[(size_t)a * L + l]"
    assert text.count(tail) == 1
    text = text.replace(tail, "  K3_FLUSH(l);\n" + tail)
    return text, step


def _patch_new(header):
    """The chain kernel's header: a stamp at each ``// phase:`` comment."""
    out = []
    for line in header.splitlines(keepends=True):
        m = re.match(r"\s*// phase: ([\w-]+)", line)
        if m:
            name = m.group(1).replace("-", " ")
            out.append(f"  K3_STAMP({NEW_PHASES.index(name)});\n")
        out.append(line)
    header = "".join(out)
    head = "  // the stamps' declarations\n"
    tail = "  // the stamps' flush\n"
    assert header.count(head) == 1 and header.count(tail) == 1
    header = header.replace(
        head, head + f"  K3_BEGIN({NEW_PHASES.index('rest')});\n")
    return header.replace(tail, tail + "  K3_FLUSH(blockIdx.x);\n")


def phase_library(kind):
    """Build the stamped copy of K3's source of ``kind`` (``"old"``: the
    warp kernel; ``"new"``: the chain kernel); returns its library stem
    and the library loaded, with the entry points' argument types set."""
    from metran_tpu_torch.kernels import build

    stem = "lanes_filter_warp" if kind == "old" else "lanes_filter"
    names = OLD_PHASES if kind == "old" else NEW_PHASES
    warps = 2 if kind == "old" else 4
    out = build.BUILD_DIR / "k3_phases"
    out.mkdir(parents=True, exist_ok=True)
    headers = {hdr.name: hdr.read_text() for hdr in build.CSRC.glob("*.cuh")}
    text = (build.CSRC / f"{stem}.cu").read_text()
    if kind == "old":
        text, headers["lanes_step.cuh"] = _patch_old(
            text, headers["lanes_step.cuh"])
    else:
        headers["lanes_chain_step.cuh"] = _patch_new(
            headers["lanes_chain_step.cuh"])
    for name, body in headers.items():
        (out / name).write_text(body)
    fmt = dict(n=len(names), max_lanes=MAX_LANES, warps=warps,
               end=len(names) - 1)
    (out / f"{stem}.cu").write_text(PRELUDE.format(**fmt) + text
                                    + READ.format(**fmt))
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
    lib.k3_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return stem, lib


def filter_cases(dtype=None, t=None):
    """K3's launches at the flagship shape: ``{name: (args, keep_bounds,
    observed slots a step)}`` for the trial pass (``chip_smoke.lanes_case``
    with K = 4 trial lanes over 512 data lanes), B = 512 with boundaries
    and B = 1 with boundaries."""
    import numpy as np
    import torch

    import chip_smoke as cs

    dtype = dtype or torch.float32
    t = t or cs.T_STEPS
    rng = np.random.default_rng(cs.SEED + 21)
    *trial, count = cs.lanes_case(rng, cs.FLEET, t, dtype,
                                  torch.device("cuda"), trials=cs.LS_TRIALS)
    per_step = float(count.double().mean())

    def first(b):
        return ([a[..., :b].contiguous() for a in trial[:4]]
                + [trial[4][:b].contiguous(), trial[5][:b].contiguous(),
                   trial[6][:b].contiguous()])

    return {f"K*B={cs.LS_TRIALS * cs.FLEET} trials": (trial, False, per_step),
            f"B={cs.FLEET} with boundaries": (first(cs.FLEET), True,
                                              per_step),
            "B=1 with boundaries": (first(1), True,
                                    float(count[:, 0].double().mean()))}


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def _equal(x, y):
    """``torch.equal`` with NaN in the same places (None equals None)."""
    import torch

    if x is None or y is None:
        return x is None and y is None
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    nx, ny = torch.isnan(x), torch.isnan(y)
    return bool(torch.equal(nx, ny)) and bool(torch.equal(x[~nx], y[~ny]))


def same(a, b):
    return all(_equal(x, y) for x, y in zip(a, b))


def job_phases(kind, smi):
    import torch

    import chip_smoke as cs
    from metran_tpu_torch.kernels import build
    from metran_tpu_torch.kernels import lanes as kl

    stem, stamped = phase_library(kind)
    real = build.load_library(stem)
    run = {"old": kl.lanes_filter_warp_kernel,
           "new": kl.lanes_filter_kernel}[kind]
    names = OLD_PHASES if kind == "old" else NEW_PHASES
    slot = OLD_SLOT if kind == "old" else NEW_SLOT
    seg = 100
    for case, (args, bounds, per_step) in filter_cases().items():
        b = args[0].shape[1]

        def go():
            return run(*args, seg=seg, keep_bounds=bounds)

        ms, want = cs.cuda_ms(go, reps=3, warm=1)
        build._libs[stem] = stamped
        try:
            stamped.k3_phase_clear()
            ms_stamped, got = cs.cuda_ms(go, reps=1, warm=0)
            raw = torch.zeros(MAX_LANES * len(names), dtype=torch.int64)
            err = stamped.k3_phase_read(raw.data_ptr(), MAX_LANES)
            require(err == 0, f"k3_phase_read: CUDA error {err}")
        finally:
            build._libs[stem] = real
        steps = -(-cs.T_STEPS // seg) * seg
        lanes = min(b, MAX_LANES)
        cyc = raw.view(MAX_LANES, len(names))[:lanes].double().mean(0)
        per = cyc / steps
        share = per / per.sum()
        entry = {"job": f"phases-{kind}", "case": case, "B": b,
                 "shape": f"(20,21) f32 T={cs.T_STEPS} seg={seg}",
                 "ms": ms, "ms_stamped": ms_stamped,
                 "us_per_step": ms * 1e3 / steps,
                 "observed_slots_per_step": per_step,
                 "cycles_per_step": float(per.sum()),
                 "bitwise_stamped": same(got, want),
                 "phases": {
                     name: {"cycles_per_step": float(c),
                            **({"cycles_per_slot": float(c) / per_step}
                               if i in slot else {}),
                            "share": float(s),
                            "us_per_step": float(s) * ms * 1e3 / steps}
                     for i, (name, c, s) in enumerate(zip(names, per, share))
                     if c > 0},
                 "card": smi}
        if kind == "new":
            entry["shape_chosen"] = list(kl.chain_shape(
                b, cs.N_SERIES, cs.N_SERIES + cs.N_FACTORS, torch.float32,
                torch.device("cuda")))
        print(json.dumps(entry), flush=True)


def job_times(smi):
    import chip_smoke as cs
    from metran_tpu_torch.kernels import lanes as kl

    for key, entry in cs.k3_times(kl, cs.DEVICE, reps=3).items():
        print(json.dumps({"job": "times", "case": key,
                          "shape": f"(20,21) f32 T={cs.T_STEPS} "
                                   f"seg={cs.K4_SEG}", **entry,
                          "card": smi}), flush=True)
        require(entry["bitwise"], f"{key}: chain and warp kernels differ")


def job_wide(smi):
    import numpy as np
    import torch

    import chip_smoke as cs
    from metran_tpu_torch.kernels import lanes as kl

    t, seg = 1_000, 100
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chooser = kl.chain_shape
    for dtype in (torch.float32, torch.float64):
        rng = np.random.default_rng(cs.SEED + 22)
        *full, _ = cs.lanes_case(rng, cs.FLEET, t, dtype,
                                 torch.device("cuda"), trials=8)
        for b in (1_024, 2_048, 4_096):
            args = ([a[..., :b].contiguous() for a in full[:4]]
                    + [full[4], full[5], full[6][:b].contiguous()])

            def go(fn):
                return fn(*args, seg=seg, keep_bounds=True)

            chosen = chooser(b, cs.N_SERIES, cs.N_SERIES + 1, dtype,
                             torch.device("cuda"))
            ms = {}
            ms["oracle"], want = cs.cuda_ms(
                lambda: go(kl.lanes_filter_warp_kernel), reps=3, warm=1)
            bitwise, resident = {}, {}
            try:
                for u in kl.UPDATE_WARPS:
                    kl.chain_shape = lambda *a, u=u: kl.ChainShape(u)
                    key = f"U={u}"
                    ms[key], got = cs.cuda_ms(
                        lambda: go(kl.lanes_filter_kernel), reps=3, warm=1)
                    bitwise[key] = same(got, want)
                    resident[key] = sms * kl.chain_occupancy(
                        cs.N_SERIES, cs.N_SERIES + 1, dtype, u)
            finally:
                kl.chain_shape = chooser
            ms["chosen"], got = cs.cuda_ms(
                lambda: go(kl.lanes_filter_kernel), reps=3, warm=1)
            bitwise["chosen"] = same(got, want)
            print(json.dumps({
                "job": "wide", "case": f"B={b} T={t} (20,21) seg={seg}",
                "dtype": str(dtype).replace("torch.", ""), "ms": ms,
                "ratio_vs_oracle": ms["oracle"] / ms["chosen"],
                "chosen": list(chosen), "bitwise": bitwise,
                "resident_lanes": resident, "card": smi}), flush=True)
            require(all(bitwise.values()),
                    f"B={b} {dtype}: chain and warp kernels differ: "
                    f"{bitwise}")


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
                                           fleet_stderr, pack_fleet)

    rng = np.random.default_rng(cs.SEED + 30)  # phase 5's fleet
    y, mask, lds, _, _ = cs.make_workload(rng, cs.FLEET, t=cs.T_STEPS)
    names = [f"s{j}" for j in range(cs.N_SERIES)]
    y32 = y.astype(np.float32)
    fleet = pack_fleet([Panel(y32[i], mask[i], None, names,
                              np.ones(cs.N_SERIES), np.zeros(cs.N_SERIES),
                              1.0) for i in range(cs.FLEET)], list(lds),
                       dtype=torch.float32, device=torch.device("cuda"))
    p0 = autocorr_init_params(fleet)
    chain_kernel = kl.lanes_filter_kernel
    k3 = {"lanes_filter_kernel"}

    def routed(route, run):
        if route == "oracle":
            kl.lanes_filter_kernel = kl.lanes_filter_warp_kernel
        try:
            reset_launches()
            before = oracle_launches()
            with cs._KernelTimer() as timer:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                k3_ms = timer.kernel_ms(names=k3)
                k_ms = timer.kernel_ms()
            after = oracle_launches()
        finally:
            kl.lanes_filter_kernel = chain_kernel
        return out, {"k3": route, "wall_s": wall, "k3_ms": k3_ms,
                     "k3_share": k3_ms / 1e3 / wall, "kernel_ms": k_ms,
                     "launches": {k: v for k, v in launches().items() if v},
                     "oracle_launches": {k: after[k] - before[k]
                                         for k in after
                                         if after[k] != before[k]}}

    fits, errs = {}, {}
    for route in ("chain", "oracle"):
        fit, info = routed(route, lambda: fit_fleet(fleet, p0=p0, **cs.FIT))
        fits[route] = fit
        print(json.dumps({
            "job": "fit", "case": f"lanes fit, {cs.FLEET} models", **info,
            "fits_per_s": cs.FLEET / info["wall_s"],
            "iterations_mean": float(fit.iterations.float().mean()),
            "iterations_max": int(fit.iterations.max()),
            "deviance_mean": float(fit.deviance.double().mean()),
            "card": smi}), flush=True)
    a, b = fits["chain"], fits["oracle"]
    agree = {key: bool(torch.equal(getattr(a, key), getattr(b, key)))
             for key in ("params", "deviance", "iterations", "converged")}
    print(json.dumps({"job": "fit", "case": "lanes fit", "bitwise": agree,
                      "card": smi}), flush=True)
    require(all(agree.values()), f"the two lanes fits differ: {agree}")

    for route in ("chain", "oracle"):
        err, info = routed(route, lambda: fleet_stderr(
            fits["chain"].params, fleet, method="lanes-fd",
            remat_seg=cs.FIT["remat_seg"])[0])
        errs[route] = err
        print(json.dumps({
            "job": "fit", "case": f"lanes-fd stderr, {cs.FLEET} models",
            **info, "nan": int(torch.isnan(err).sum()), "card": smi}),
            flush=True)
    agree = _equal(errs["chain"], errs["oracle"])
    print(json.dumps({"job": "fit", "case": "lanes-fd stderr",
                      "bitwise": agree, "card": smi}), flush=True)
    require(agree, "the two stderr passes differ")

    solved = {}
    for route in ("chain", "oracle"):
        mt = Metran(cs.flagship_series(cs.SEED + 70), name="flagship")
        _, info = routed(route, lambda: mt.solve(report=False))
        solved[route] = mt
        print(json.dumps({
            "job": "fit", "case": "flagship Metran.solve()", **info,
            "iterations": int(mt.fit.fleet_fit.iterations[0]),
            "nfev": int(mt.fit.nfev), "obj_func": mt.fit.obj_func,
            "card": smi}), flush=True)
    a, b = solved["chain"], solved["oracle"]
    agree = {
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
                      "bitwise": agree, "card": smi}), flush=True)
    require(all(agree.values()), f"the two solves differ: {agree}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", default="phases-old,phases-new,times,wide,fit")
    args = ap.parse_args()
    jobs = args.jobs.split(",")
    import torch

    from metran_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("torch_k3_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    if "fit" not in jobs:  # only the two K3 kernels
        stems = ["lanes_filter_warp"]
        if jobs != ["phases-old"]:
            stems.append("lanes_filter")
        build.sources = lambda: [build.CSRC / f"{s}.cu" for s in stems]
    t0 = time.perf_counter()
    build.build()
    ptxas = {src: [line.strip() for line in text.splitlines()
                   if "Used" in line or "spill" in line][:16]
             for src, text in build.build_info.get("ptxas", {}).items()
             if src.startswith("lanes_filter")}
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "ptxas": ptxas}), flush=True)
    for job in jobs:
        if job.startswith("phases-"):
            job_phases(job.removeprefix("phases-"), smi)
        elif job == "times":
            job_times(smi)
        elif job == "wide":
            job_wide(smi)
        elif job == "fit":
            job_fit(smi)
        else:
            raise SystemExit(f"unknown job {job}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
