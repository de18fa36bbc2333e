#!/usr/bin/env python3
"""Kernel K9 (the square-root filter) on one CUDA card: the group kernel
(several warps a model, ``csrc/sqrt_warp_step.cuh``) against the block
kernel it replaced (``csrc/sqrt_step.cuh``), both built from this
checkout and run in one process.

Usage, from the root of a checkout::

    python3 tools/torch_k9_ab.py [--jobs phases-block,phases-new,fit,wide]

Jobs (default: all four):

- ``phases-block``, ``phases-new``: a copy of ``sqrt_filter_block.cu``
  or ``sqrt_filter.cu`` whose step body (``sqrt_step.cuh``,
  ``sqrt_warp_step.cuh``) is patched with
  ``clock64()`` stamps at its phases is built into
  ``kernels/build/k9_phases/`` (the sources in ``csrc/`` are not
  touched).  The model's first thread adds the cycles from one stamp to
  the next to its phase: the predict build (with the mask compaction),
  the predict QR, S_p, the gate or robust solve, the innovations and the
  update pre-array, the update QR, ok and the logs, the forward
  substitution, m and S_f, and the rest (the stores, the boundaries and
  the loop top).  In the group kernel the forward substitution rides
  beside the update QR on another thread, so its phase there is what
  the first thread waits for it.  Run at the flagship shape (N = 20,
  n = 21, f32, T = 5,000): ``bounds`` (seg 128) at B = 512 and
  ``store`` at B = 1; prints each phase's cycles a step (mean over
  models), its share, and that share of the uninstrumented kernel's
  CUDA-event time a step.
- ``fit``: ``chip_smoke.py``'s 16-model square-root batch fit (phase 5's
  fleet, ``SQRT_FIT``) with K9 on the group kernel, then routed to the
  block kernel: walls, objective calls, K9's share, and whether the
  fitted parameters, deviances and iterations agree bit for bit.  The
  first fit of the process pays its warm-up: compare K9 times.
- ``wide``: ``bounds`` at T = 1,000 over B = 1 to 4,096, f32 and f64:
  the block kernel and the group kernel (``launch_shape``'s choice, and
  the other launch shapes), each held to the block kernel with
  ``torch.equal``, beside the four-warp blocks the card keeps resident.

The two kernels' alternating times at the flagship and serving shapes
are ``chip_smoke.py``'s (its ``k9_times`` line).

Prints JSON lines and the card's ``nvidia-smi`` name and power limit.
Needs a card; imports no JAX.
"""

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

PHASES = ("predict build", "predict QR", "S_p", "gate", "pre-array",
          "update QR", "ok and logs", "forward", "m and S_f", "rest")
# sqrt_step.cuh's lines that open each phase (inserted before the line);
# the loop top opens "rest", which also takes the stores and boundaries
BLOCK_ANCHORS = (
    ("    // ---- predict: m_p, and the pre-array [(phi o S)' ; "
     "diag sqrt q]\n", 0),
    ("    // column j of the pre-array is nonzero in rows [j, n + j] only\n",
     1),
    ("    for (int idx = tid; idx < nn; idx += kThreads) {\n"
     "      const int a = idx / n, b = idx % n;  // S_p[a, b] = sign_b "
     "R[b, a]\n", 2),
    ("      // the gate, on each observed slot's marginal innovation off "
     "S_p\n", 3),
    ("      // innovations of the observed slots\n", 4),
    ("      sqrtqr::house_qr<T, kThreads>(s.ua, ldu, R, R, o, R, s.dg);\n",
     5),
    ("      // ok: F^1/2 diagonal nonzero (positive once normalised), "
     "every\n", 6),
    ("        // w = F^-1/2' \\ v by forward substitution on the "
     "unnormalised R\n", 7),
    ("      if (bad) {\n", 8),
    ("      // predict-only: S_f = S_p exactly; ok iff S_p is finite\n", 8),
    ("    // ---- outputs of the step\n", 9),
)
# sqrt_warp_step.cuh's "// phase: <name>" lines, by their first word
NEW_ANCHORS = {"predict": 0, "QR": 1, "S_p": 2, "gate": 3, "pre-array": 4,
               "update": 5, "ok": 6, "forward": 7, "m": 8, "end": 9}
MAX_MODELS = 4096
PRELUDE = f"""#include <cuda_runtime.h>
__device__ long long k9_phase[{MAX_MODELS} * 10];
#define K9_STAMP(i)                         \\
  do {{                                      \\
    if (k9_rec) {{                           \\
      const long long now = clock64();      \\
      k9_acc[k9_cur] += now - k9_last;      \\
      k9_last = now;                        \\
      k9_cur = (i);                         \\
    }}                                       \\
  }} while (0)
"""
DECLS = ("  long long k9_acc[10] = {{0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};\n"
         "  long long k9_last = clock64();\n  int k9_cur = 9;\n"
         "  const bool k9_rec = {rec};\n")
FLUSH = ("  K9_STAMP(9);\n  if (k9_rec && l < {max_models})\n"
         "    for (int i = 0; i < 10; ++i) k9_phase[(size_t)l * 10 + i] = "
         "k9_acc[i];\n").format(max_models=MAX_MODELS)
READ = """
extern "C" int k9_phase_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, k9_phase, (size_t)n * 10 * 8);
}
"""
LOOP_TOP = "  for (int t = 0; t < t_steps; ++t) {\n"


def _patch_block(text):
    for line, i in BLOCK_ANCHORS:
        assert text.count(line) == 1, line
        text = text.replace(line, f"    K9_STAMP({i});\n" + line)
    assert text.count(LOOP_TOP) == 1
    text = text.replace(LOOP_TOP, LOOP_TOP + "    K9_STAMP(9);\n")
    head = "  const T thresh = T(thresh_d);\n"
    assert text.count(head) == 1
    text = text.replace(head, head + DECLS.format(rec="threadIdx.x == 0"))
    tail = "  }\n}\n\n}  // namespace sqrtk"
    assert text.count(tail) == 1
    return text.replace(tail, "  }\n" + FLUSH + "}\n\n}  // namespace sqrtk")


def _patch_new(text):
    out = []
    for line in text.splitlines(keepends=True):
        m = re.match(r"\s*// phase: ([\w-]+)", line)
        if m:
            out.append(f"    K9_STAMP({NEW_ANCHORS[m.group(1)]});\n")
        out.append(line)
        if line == LOOP_TOP:
            out.append("    K9_STAMP(9);\n")
    text = "".join(out)
    head = "  // the stamps' declarations\n"
    assert text.count(head) == 1
    text = text.replace(head, head + DECLS.format(rec="g.t == 0"))
    tail = "  // the stamps' flush\n"
    assert text.count(tail) == 1
    return text.replace(tail, tail + FLUSH)


def phase_library(kind):
    """Build the stamped copy of K9's source of ``kind`` (``"block"``:
    ``sqrt_filter_block.cu`` over ``sqrt_step.cuh``; ``"new"``:
    ``sqrt_filter.cu`` over ``sqrt_warp_step.cuh``); returns its library
    stem and the library loaded, with the entry points' argument types
    set."""
    from metran_tpu_torch.kernels import build

    stem = "sqrt_filter_block" if kind == "block" else "sqrt_filter"
    out = build.BUILD_DIR / "k9_phases"
    out.mkdir(parents=True, exist_ok=True)
    for hdr in build.CSRC.glob("*.cuh"):
        text = hdr.read_text()
        if hdr.name == "sqrt_step.cuh":
            text = _patch_block(text)
        elif hdr.name == "sqrt_warp_step.cuh":
            text = _patch_new(text)
        (out / hdr.name).write_text(text)
    (out / f"{stem}.cu").write_text(
        PRELUDE + (build.CSRC / f"{stem}.cu").read_text() + READ)
    lib_path = out / f"lib{stem}_phases.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                           str(out / f"{stem}.cu"), "-o", str(lib_path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    for base, argtypes in build._SIGNATURES[stem]:
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.metran_error_string.argtypes = [ctypes.c_int]
    lib.metran_error_string.restype = ctypes.c_char_p
    lib.k9_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return stem, lib


def bounds_args(b, t, dtype=None):
    """K9's ``bounds`` arguments at the flagship shape: the first ``b``
    models of ``chip_smoke.py``'s timed fleet over ``t`` steps, lanes
    layout, from (0, I)."""
    import numpy as np
    import torch

    import chip_smoke as cs

    dtype = dtype or torch.float32
    rng = np.random.default_rng(cs.SEED + 95)
    ss, y, mask = cs._adjoint_case(rng, cs.FLEET, t, dtype,
                                   torch.device("cuda"))
    qd = torch.diagonal(ss.q, 0, -2, -1)
    lanes = (ss.phi.T, qd.T, ss.z.permute(1, 2, 0), ss.r.T, y, mask)
    return [lanes[0][:, :b], lanes[1][:, :b], lanes[2][..., :b],
            lanes[3][:, :b], y[:b], mask[:b]]


def store_args(t):
    """K9's ``store`` arguments: one flagship lane over ``t`` steps
    (``chip_smoke.py``'s timed ``sqrt_kernels`` case)."""
    import numpy as np
    import torch

    import chip_smoke as cs

    rng = np.random.default_rng(cs.SEED + 82)
    *args, _ = cs.lanes_case(rng, 1, t, torch.float32, torch.device("cuda"))
    return args


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def job_phases(kind, smi):
    import torch

    import chip_smoke as cs
    from metran_tpu_torch.kernels import build
    sf = importlib.import_module("metran_tpu_torch.kernels.sqrt_filter")

    stem, stamped = phase_library(kind)
    real = build.load_library(stem)
    run = {"block": sf.sqrt_filter_block, "new": sf.sqrt_filter_kernel}[kind]
    cases = (("bounds", cs.FLEET, lambda: [a.contiguous() for a in
                                           bounds_args(cs.FLEET,
                                                       cs.T_STEPS)],
              dict(bounds_seg=cs.ADJ_SEG)),
             ("store", 1, lambda: store_args(cs.T_STEPS), dict(store=True)))
    for mode, b, make, kw in cases:
        args = make()
        ms, _ = cs.cuda_ms(lambda: run(*args, **kw), reps=3, warm=1)
        build._libs[stem] = stamped
        try:
            ms_stamped, _ = cs.cuda_ms(lambda: run(*args, **kw), reps=3,
                                       warm=1)
            raw = torch.zeros(MAX_MODELS * 10, dtype=torch.int64)
            err = stamped.k9_phase_read(raw.data_ptr(), MAX_MODELS)
            require(err == 0, f"k9_phase_read: CUDA error {err}")
        finally:
            build._libs[stem] = real
        cyc = raw.view(MAX_MODELS, 10)[:b].double().mean(0) / cs.T_STEPS
        share = cyc / cyc.sum()
        us_step = ms * 1e3 / cs.T_STEPS
        print(json.dumps({
            "job": f"phases-{kind}", "mode": mode, "B": b,
            "shape": f"(20,21) f32 T={cs.T_STEPS}"
                     + (f" seg={cs.ADJ_SEG}" if mode == "bounds" else ""),
            "ms": ms, "ms_stamped": ms_stamped, "us_per_step": us_step,
            "cycles_per_step": float(cyc.sum()),
            "phases": {name: {"cycles": float(c), "share": float(s),
                              "us": float(s) * us_step}
                       for name, c, s in zip(PHASES, cyc, share)},
            "card": smi}), flush=True)


def job_wide(smi):
    """``bounds`` at T = 1,000, the flagship models repeated to B = 1 ...
    4,096, in f32 and f64: the block kernel, and the group kernel at
    ``launch_shape``'s choice, four warps a lane two lanes a block, and
    two warps a lane at every width that fits, each held to the block
    kernel with ``torch.equal``."""
    import torch

    import chip_smoke as cs
    sf = importlib.import_module("metran_tpu_torch.kernels.sqrt_filter")

    t = 1_000
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chooser = sf.launch_shape
    for dtype in (torch.float32, torch.float64):
        base = bounds_args(cs.FLEET, t, dtype)
        n_obs, n_state = base[2].shape[0], base[2].shape[1]
        resident = sms * sf.occupancy(n_obs, n_state, dtype, "bounds", 1,
                                      sf.MAX_GROUP)
        for b in (1, 8, 64, 512, 1_024, 2_048, 4_096):
            reps = -(-b // cs.FLEET)
            args = [a.repeat(*([1] * (a.dim() - 1)), reps)[..., :b]
                    .contiguous() if i < 4
                    else a.repeat(reps, *([1] * (a.dim() - 1)))[:b]
                    .contiguous() for i, a in enumerate(base)]
            chosen = chooser(b, n_obs, n_state, args[0].dtype, args[0].device,
                             "bounds")
            fit = sf.MAX_SMEM // sf.model_bytes(n_obs, n_state, dtype)
            shapes = list(dict.fromkeys(
                [chosen, (min(2, fit), sf.MAX_GROUP)]
                + [(w, sf.MIN_GROUP) for w in range(
                    1, min(sf.MAX_WARPS // sf.MIN_GROUP, fit) + 1)]))
            ms = {}
            ms["block"], want = cs.cuda_ms(
                lambda: sf.sqrt_filter_block(*args, bounds_seg=cs.ADJ_SEG),
                reps=3, warm=1)
            same = True
            try:
                for shape in shapes:
                    sf.launch_shape = lambda *a, shape=shape: shape
                    ms[str(shape)], got = cs.cuda_ms(
                        lambda: sf.sqrt_filter_kernel(
                            *args, bounds_seg=cs.ADJ_SEG), reps=3, warm=1)
                    same = same and all(_equal(x, y)
                                        for x, y in zip(got, want))
            finally:
                sf.launch_shape = chooser
            print(json.dumps({
                "job": "wide", "case": f"bounds B={b} T={t} "
                f"({n_obs},{n_state}) seg={cs.ADJ_SEG}",
                "dtype": str(dtype).replace("torch.", ""), "ms": ms,
                "speedup": ms["block"] / ms[str(chosen)],
                "bitwise": same, "four_warp_resident": resident,
                "chosen": chosen, "card": smi}), flush=True)
            require(same, f"B={b} {dtype}: group and block kernels differ")


def _equal(x, y):
    """``torch.equal`` with NaN in the same places."""
    import torch

    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.is_floating_point():
        nx, ny = torch.isnan(x), torch.isnan(y)
        return bool(torch.equal(nx, ny)) and bool(torch.equal(x[~nx],
                                                              y[~ny]))
    return bool(torch.equal(x, y))


def job_fit(smi):
    import numpy as np
    import torch

    import chip_smoke as cs
    from metran_tpu_torch.data import Panel
    from metran_tpu_torch.kernels import launches, reset_launches
    sf = importlib.import_module("metran_tpu_torch.kernels.sqrt_filter")
    from metran_tpu_torch.kernels.build import oracle_launches
    from metran_tpu_torch.parallel import (Fleet, autocorr_init_params,
                                           fit_fleet, pack_fleet)

    rng = np.random.default_rng(cs.SEED + 30)  # phase 5's fleet
    y, mask, lds, _, _ = cs.make_workload(rng, cs.FLEET, t=cs.T_STEPS)
    names = [f"s{j}" for j in range(cs.N_SERIES)]
    y32 = y.astype(np.float32)
    fleet = pack_fleet([Panel(y32[i], mask[i], None, names,
                              np.ones(cs.N_SERIES), np.zeros(cs.N_SERIES),
                              1.0) for i in range(cs.FLEET)], list(lds),
                       dtype=torch.float32, device=torch.device("cuda"))
    p0 = autocorr_init_params(fleet)
    sel = torch.arange(cs.SQRT_FIT_MODELS, device=fleet.y.device)
    small = Fleet(*(None if a is None else a.index_select(0, sel)
                    for a in fleet))
    new_kernel = sf.sqrt_filter_kernel
    fits = {}
    for route in ("new", "block", "new", "block"):
        if route == "block":
            sf.sqrt_filter_kernel = sf.sqrt_filter_block
        try:
            reset_launches()
            before = oracle_launches()
            with cs._KernelTimer() as timer, cs._RowCounter() as rows:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fit = fit_fleet(small, p0=p0[:cs.SQRT_FIT_MODELS],
                                engine="sqrt", grad_engine="adjoint",
                                **cs.SQRT_FIT)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                k9_ms = timer.kernel_ms(names={"sqrt_filter_kernel"})
                k11_ms = timer.kernel_ms(names={"joint_adjoint_kernel"})
            after = oracle_launches()
        finally:
            sf.sqrt_filter_kernel = new_kernel
        fits.setdefault(route, fit)
        print(json.dumps({
            "job": "fit", "k9": route, "models": cs.SQRT_FIT_MODELS,
            "wall_s": wall, "objective_calls": rows.calls,
            "iterations_mean": float(fit.iterations.float().mean()),
            "k9_ms": k9_ms, "k9_share": k9_ms / 1e3 / wall,
            "k11_ms": k11_ms, "k11_share": k11_ms / 1e3 / wall,
            "launches": {k: v for k, v in launches().items() if v},
            "oracle_launches": {k: after[k] - before[k] for k in after
                                if after[k] != before[k]},
            "deviance_mean": float(fit.deviance.double().mean()),
            "card": smi}), flush=True)
    a, b = fits["new"], fits["block"]
    same = {key: bool(torch.equal(getattr(a, key), getattr(b, key)))
            for key in ("params", "deviance", "iterations", "converged")}
    print(json.dumps({"job": "fit", "bitwise": same, "card": smi}),
          flush=True)
    require(all(same.values()), f"the two fits differ: {same}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", default="phases-block,phases-new,fit,wide")
    jobs = ap.parse_args().jobs.split(",")
    import torch

    from metran_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("torch_k9_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    if "fit" not in jobs:  # only K9 is needed
        build.sources = lambda: [build.CSRC / "sqrt_filter.cu",
                                 build.CSRC / "sqrt_filter_block.cu"]
    t0 = time.perf_counter()
    build.build()
    ptxas = [line.strip() for line in build.build_info.get(
        "ptxas", {}).get("sqrt_filter.cu", "").splitlines()
        if "Used" in line or "spill" in line]
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "ptxas_sqrt_filter": ptxas[:12]}), flush=True)
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
