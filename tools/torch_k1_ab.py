#!/usr/bin/env python3
"""Kernel K1 (the joint filter) on one CUDA card: the warp kernel (a
group of warps per model) against the block kernel it replaced, both
built from this checkout and run in one process.

Usage, from the root of a checkout::

    python3 tools/torch_k1_ab.py [--jobs phases-block,phases-warp,fit,wide]

Jobs (default: all four):

- ``phases-block``, ``phases-warp``: a copy of ``joint_filter.cu`` whose
  step body (``joint_step.cuh``, ``joint_warp_step.cuh``) is patched with
  ``clock64()`` stamps at its phase comments is built into
  ``kernels/build/k1_phases/`` (the sources in ``csrc/`` are not
  touched).  The model's first thread (either kernel) adds the cycles
  from one stamp to the next to its phase: predict, ``Z_m P`` (with ``v``), F, Cholesky, the
  solves, the update (``m``, ``K F``, the terms), ``P -= ...`` and the
  rest (the loop top, boundary and store writes, the prefetch).  Run at
  the flagship shape (N = 20, S = 21, f32, T = 5,000, seg 128
  boundaries) at B = 512 and 1; prints each phase's cycles a step
  (mean over models), its share, and that share of the uninstrumented
  kernel's CUDA-event time a step.
- ``fit``: ``chip_smoke.py``'s 512-model batch fit (phase 5's fleet,
  ``BATCH_FIT``) with K1 on the warp kernel, then with K1 routed to the
  block kernel: walls, objective calls, the K1 share, and whether the
  fitted parameters, deviances and iterations agree bit for bit.  The
  first fit of the process pays its warm-up: compare K1 times.
- ``wide``: where four warps a model stop paying, to place
  ``block_shape``'s switch: ``bounds``, T = 1,000, B = 512 to 4,096, f32
  and f64, the block kernel and the warp kernel at four warps a model
  and at one, beside the four-warp blocks the card keeps resident.

The two kernels' alternating times at the flagship and serving shapes
are ``chip_smoke.py``'s (its ``k1_times`` line).

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

PHASES = ("predict", "Z_m P", "F", "Cholesky", "solves", "update", "P",
          "rest")
# joint_step.cuh's comment lines that open each phase (the loop top opens
# "rest", which also takes the store and boundary writes)
BLOCK_ANCHORS = {
    "    // predict (each thread owns its entries)\n": 0,
    "    // innovation and the (masked) rows of Z P\n": 1,
    "    // F = Z_m (P Z_m') + diag(r o mask + 1 - mask)\n": 2,
    "    // right-looking Cholesky on the lower triangle of L\n": 3,
    "    // K' = L'^-1 L^-1 (Z_m P): column j of KT per thread; column S "
    "is v\n": 4,
    "    // m += K v and (K' F)' into Hm; the step's likelihood terms\n": 5,
    "    // P -= (K' F)' K'\n": 6,
    "  for (int t = 0; t < k; ++t) {\n": 7,
}
# joint_warp_step.cuh's "// phase: <name>" lines, by their first word
WARP_ANCHORS = {"predict": 0, "innovation": 1, "F": 2, "right-looking": 3,
                "solves.": 4, "update.": 5, "P": 6, "end": 7}
MAX_MODELS = 4096
PRELUDE = f"""#include <cuda_runtime.h>
__device__ long long k1_phase[{MAX_MODELS} * 8];
#define K1_STAMP(i)                         \\
  do {{                                      \\
    if (k1_rec) {{                           \\
      const long long now = clock64();      \\
      k1_acc[k1_cur] += now - k1_last;      \\
      k1_last = now;                        \\
      k1_cur = (i);                         \\
    }}                                       \\
  }} while (0)
"""
DECLS = ("  long long k1_acc[8] = {{0, 0, 0, 0, 0, 0, 0, 0}};\n"
         "  long long k1_last = clock64();\n  int k1_cur = 7;\n"
         "  const bool k1_rec = {rec};\n")
FLUSH = ("  K1_STAMP(7);\n  if (k1_rec && b < {max_models})\n"
         "    for (int i = 0; i < 8; ++i) k1_phase[(size_t)b * 8 + i] = "
         "k1_acc[i];\n").format(max_models=MAX_MODELS)
READ = """
extern "C" int k1_phase_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, k1_phase, (size_t)n * 8 * 8);
}
"""


def _patch_block(text):
    for line, i in BLOCK_ANCHORS.items():
        assert text.count(line) == 1, line
        text = text.replace(line, line + f"    K1_STAMP({i});\n")
    head = "  const int nt = blockDim.x;\n"
    assert text.count(head) == 1
    text = text.replace(head, head + DECLS.format(rec="threadIdx.x == 0"))
    tail = "  __syncthreads();\n}\n\n}  // namespace jointk"
    assert text.count(tail) == 1
    return text.replace(tail, FLUSH + tail)


def _patch_warp(text):
    out = []
    for line in text.splitlines(keepends=True):
        out.append(line)
        m = re.match(r"\s*// phase: (\S+)", line)
        if m:
            out.append(f"    K1_STAMP({WARP_ANCHORS[m.group(1)]});\n")
        elif line == "  for (int t = 0; t < k; ++t) {\n":
            out.append("    K1_STAMP(7);\n")
    text = "".join(out)
    assert text.count("K1_STAMP(") == 9, text.count("K1_STAMP(")
    head = "  const T* rb = r + (size_t)b * N;\n"
    assert text.count(head) == 1
    text = text.replace(head, head + DECLS.format(rec="g.t == 0"))
    tail = "}\n\n}  // namespace jointw"
    assert text.count(tail) == 1
    return text.replace(tail, FLUSH + tail)


def phase_library():
    """Build the stamped copy of ``joint_filter.cu``; returns it loaded,
    with the entry points' argument types set."""
    from metran_tpu_torch.kernels import build

    out = build.BUILD_DIR / "k1_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "joint_step.cuh").write_text(
        _patch_block((build.CSRC / "joint_step.cuh").read_text()))
    (out / "joint_warp_step.cuh").write_text(
        _patch_warp((build.CSRC / "joint_warp_step.cuh").read_text()))
    (out / "joint_filter.cu").write_text(
        PRELUDE + (build.CSRC / "joint_filter.cu").read_text() + READ)
    lib_path = out / "libk1_phases.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                           str(out / "joint_filter.cu"), "-o", str(lib_path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    for base, argtypes in build._SIGNATURES["joint_filter"]:
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.metran_error_string.argtypes = [ctypes.c_int]
    lib.metran_error_string.restype = ctypes.c_char_p
    lib.k1_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def flagship(b, t):
    """K1's arguments at the flagship shape: ``b`` models of
    ``chip_smoke.py``'s timed fleet over ``t`` steps, from N(0, I)."""
    import numpy as np
    import torch

    import chip_smoke as cs

    rng = np.random.default_rng(cs.SEED + 95)
    ss, y, mask = cs._adjoint_case(rng, cs.FLEET, t, torch.float32,
                                   torch.device("cuda"))
    n = ss.phi.shape[1]
    m0 = ss.phi.new_zeros((cs.FLEET, n))
    c0 = torch.eye(n, dtype=torch.float32, device=y.device).expand(
        cs.FLEET, n, n).contiguous()
    return [a[:b].contiguous() for a in (*ss, m0, c0, y, mask)]


def job_phases(kind, smi):
    import torch

    import chip_smoke as cs
    from metran_tpu_torch.kernels import build
    from metran_tpu_torch.kernels import joint_filter as jf

    real = build.load_library("joint_filter")
    stamped = phase_library()
    run = {"block": jf.joint_filter_append_block,
           "warp": jf.joint_filter_append_kernel}[kind]
    for b in (cs.FLEET, 1):
        args = flagship(b, cs.T_STEPS)
        ms, _ = cs.cuda_ms(lambda: run(*args, bounds_seg=cs.ADJ_SEG),
                           reps=3, warm=1)
        build._libs["joint_filter"] = stamped
        try:
            ms_stamped, _ = cs.cuda_ms(
                lambda: run(*args, bounds_seg=cs.ADJ_SEG), reps=3, warm=1)
            raw = torch.zeros(MAX_MODELS * 8, dtype=torch.int64)
            err = stamped.k1_phase_read(raw.data_ptr(), MAX_MODELS)
            require(err == 0, f"k1_phase_read: CUDA error {err}")
        finally:
            build._libs["joint_filter"] = real
        cyc = raw.view(MAX_MODELS, 8)[:b].double().mean(0) / cs.T_STEPS
        share = cyc / cyc.sum()
        us_step = ms * 1e3 / cs.T_STEPS
        print(json.dumps({
            "job": f"phases-{kind}", "B": b, "shape": "(20,21) f32 T=5000 "
            "seg=128", "ms": ms, "ms_stamped": ms_stamped,
            "us_per_step": us_step,
            "cycles_per_step": float(cyc.sum()),
            "phases": {name: {"cycles": float(c), "share": float(s),
                              "us": float(s) * us_step}
                       for name, c, s in zip(PHASES, cyc, share)},
            "card": smi}), flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def job_wide(smi):
    """Where four warps a model stop paying: ``bounds``, T = 1,000, the
    flagship models repeated to B = 512, 1,024, 1,536, 2,048 and 4,096, in
    f32 and f64; the block kernel, the warp kernel at four warps a model
    (a model a block), ``block_shape``'s choice and one warp a model at
    the widest block that fits, each held to the block kernel with
    ``torch.equal``; beside them the four-warp blocks resident (SMs
    times the occupancy calculator's count) and what ``block_shape``
    chooses."""
    import torch

    import chip_smoke as cs
    from metran_tpu_torch.kernels import joint_filter as jf

    t = 1_000
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chooser = jf.block_shape
    for dtype in (torch.float32, torch.float64):
        base = [a.to(dtype) if a.is_floating_point() else a
                for a in flagship(cs.FLEET, t)]
        n_obs, n_state = base[2].shape[1], base[0].shape[1]
        resident = sms * jf.occupancy(n_obs, n_state, dtype, "bounds", 1,
                                      jf.MAX_GROUP)
        widest = (min(jf.MAX_MODELS, jf.MAX_SMEM // jf.model_bytes(
            n_obs, n_state, dtype)), 1)
        for b in (512, 1_024, 1_536, 2_048, 4_096):
            # four warps a model, block_shape's choice, and one warp a
            # model at the widest block that fits
            chosen = chooser(b, n_obs, n_state, dtype, base[0].device,
                             "bounds")
            shapes = list(dict.fromkeys([(1, jf.MAX_GROUP), chosen,
                                         widest]))
            reps = -(-b // cs.FLEET)
            args = [a.repeat(reps, *([1] * (a.dim() - 1)))[:b].contiguous()
                    for a in base]
            ms = {}
            ms["block"], want = cs.cuda_ms(
                lambda: jf.joint_filter_append_block(
                    *args, bounds_seg=cs.ADJ_SEG), reps=3, warm=1)
            same = True
            try:
                for shape in shapes:
                    jf.block_shape = lambda *a, shape=shape: shape
                    ms[str(shape)], got = cs.cuda_ms(
                        lambda: jf.joint_filter_append_kernel(
                            *args, bounds_seg=cs.ADJ_SEG), reps=3, warm=1)
                    same = same and all(torch.equal(x, y)
                                        for x, y in zip(got, want))
            finally:
                jf.block_shape = chooser
            print(json.dumps({
                "job": "wide", "case": f"bounds B={b} T={t} "
                f"({n_obs},{n_state}) seg={cs.ADJ_SEG}",
                "dtype": str(dtype).replace("torch.", ""), "ms": ms,
                "bitwise": same, "four_warp_resident": resident,
                "one_warp_blocks_per_sm": {
                    str(w): jf.occupancy(n_obs, n_state, dtype, "bounds",
                                         w, 1)
                    for w in range(1, widest[0] + 1)},
                "chosen": chosen, "card": smi}), flush=True)
            require(same, f"B={b} {dtype}: warp and block kernels differ")


def job_fit(smi):
    import numpy as np
    import torch

    import chip_smoke as cs
    from metran_tpu_torch.data import Panel
    from metran_tpu_torch.kernels import joint_filter as jf
    from metran_tpu_torch.kernels import launches, reset_launches
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
    warp_kernel = jf.joint_filter_append_kernel
    fits = {}
    for route in ("warp", "block"):
        if route == "block":
            jf.joint_filter_append_kernel = jf.joint_filter_append_block
        try:
            reset_launches()
            with cs._KernelTimer() as timer, cs._RowCounter() as rows:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fit = fit_fleet(fleet, p0=p0, **cs.BATCH_FIT)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                k1_ms = timer.kernel_ms(names={"joint_filter_append_kernel"})
                k11_ms = timer.kernel_ms(names={"joint_adjoint_kernel"})
        finally:
            jf.joint_filter_append_kernel = warp_kernel
        fits[route] = fit
        print(json.dumps({
            "job": "fit", "k1": route, "wall_s": wall,
            "fits_per_s": cs.FLEET / wall, "objective_calls": rows.calls,
            "evaluations_per_model": rows.rows / cs.FLEET,
            "iterations_mean": float(fit.iterations.float().mean()),
            "converged_frac": float(fit.converged.float().mean()),
            "k1_ms": k1_ms, "k1_share": k1_ms / 1e3 / wall,
            "k11_ms": k11_ms, "k11_share": k11_ms / 1e3 / wall,
            "launches": {k: v for k, v in launches().items() if v},
            "deviance_mean": float(fit.deviance.double().mean()),
            "card": smi}), flush=True)
    a, b = fits["warp"], fits["block"]
    same = {key: bool(torch.equal(getattr(a, key), getattr(b, key)))
            for key in ("params", "deviance", "iterations", "converged")}
    print(json.dumps({"job": "fit", "bitwise": same, "card": smi}),
          flush=True)
    require(all(same.values()), f"the two fits differ: {same}")



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", default="phases-block,phases-warp,fit,wide")
    jobs = ap.parse_args().jobs.split(",")
    import torch

    from metran_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("torch_k1_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    if "fit" not in jobs:  # only K1 is needed
        build.sources = lambda: [build.CSRC / "joint_filter.cu"]
    t0 = time.perf_counter()
    build.build()
    ptxas = [line.strip() for line in build.build_info.get(
        "ptxas", {}).get("joint_filter.cu", "").splitlines()
        if "Compiling entry" in line or "Used" in line or "spill" in line]
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "ptxas_joint_filter": ptxas}), flush=True)
    for job in jobs:
        if job.startswith("phases-"):
            job_phases(job.removeprefix("phases-"), smi)
        elif job == "fit":
            job_fit(smi)
        elif job == "wide":
            job_wide(smi)
        else:
            raise SystemExit(f"unknown job {job}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
