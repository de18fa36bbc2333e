#!/usr/bin/env python3
"""Kernel K11 (the batch-layout adjoint) and the batch fits that run it,
on one CUDA card, in several checkouts.

Usage, from the root of a checkout, with each other checkout unpacked
into a directory that ``.gitignore`` lists (``git archive <commit> | tar
-x -C <dir>``)::

    python3 tools/torch_k11_fits.py [--jobs acc,time,sqrt,pert,batch]
        [--eps 0,1e-6,...] [--compact] <dir> [<dir> ...]

``.`` names this checkout.  Each directory runs in its own process, in
the order given (the first builds every kernel; the others copy its
build directory, so only their changed sources compile).  Jobs:

- ``acc``: K11 against its plain version on the card at B = 64, 16 and
  3 (T = 5,000, seg 128: 40 segments, so the ring refills), f32 and f64,
  K1 and K9 boundaries, one model degraded (r < 0); the plain versions
  (and the f64 plain version of the f32 inputs) run once, in the first
  directory, and are shared through a temporary file; each launch is
  repeated to check it is deterministic.
- ``time``: K11 by CUDA events at B = 512, 64, 8, 1 (f32) and 512, 64, 1
  (f64), flagship inputs, K1 boundaries.
- ``sqrt``: the 16-model square-root batch fit of ``chip_smoke.py``
  (``SQRT_FIT``): wall, objective calls and the rows of each, and the f32
  gradient's error against the f64 one at p0 and at the fitted
  parameters.
- ``pert``: the same fit and the 16-model joint batch fit (``BATCH_FIT``)
  from p0 · (1 + eps) for each ``--eps``: walls and objective calls.
- ``batch``: the 512-model batch fit of ``chip_smoke.py`` (``BATCH_FIT``)
  with the same counts and gradient errors on 16 of its models.

``--compact`` forces K11's compact block (checkouts whose wrapper has
``block_shape``).  Prints one JSON line per directory and the card's
``nvidia-smi`` name and power limit.  Needs a card; imports no JAX.
"""

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CHILD = r'''
import importlib, json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from metran_tpu_torch.data import Panel
from metran_tpu_torch.kernels import build, launches, reset_launches
from metran_tpu_torch.parallel import (autocorr_init_params, fit_fleet,
                                       fleet_value_and_grad, pack_fleet)
from metran_tpu_torch.parallel import fleet as pf

build.build()
ja = importlib.import_module("metran_tpu_torch.kernels.joint_adjoint")
jobs, compact, store_path, first = (sys.argv[1].split(","), sys.argv[2] == "1",
                                    sys.argv[3], sys.argv[4] == "1")
eps_list = [float(x) for x in sys.argv[5].split(",")]
dev = torch.device("cuda")
if compact:
    ja.block_shape = lambda *a: ja.COMPACT
out = {}


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        return float("nan")
    return float((a - b).norm() / b.norm())


class Sizes:
    """The rows of every batch-objective call."""
    def __enter__(self):
        self.sizes, self.saved = [], pf._model_deviance
        def counted(p, *a, **k):
            self.sizes.append(int(p.shape[0]))
            return self.saved(p, *a, **k)
        pf._model_deviance = counted
        return self
    def __exit__(self, *e):
        pf._model_deviance = self.saved


if "acc" in jobs:
    if first:
        store = {}
        for dtype in (torch.float32, torch.float64):
            for engine in ("joint", "sqrt"):
                rng = np.random.default_rng(cs.SEED + 97)
                ss, y, mask = cs._adjoint_case(rng, 64, cs.T_STEPS, dtype,
                                               dev, degraded=True)
                bm, bc, fac = cs._boundaries(engine, ss, y, mask, cs.ADJ_SEG)
                sb, db = (torch.as_tensor(rng.uniform(0.5, 1.5, y.shape[:2]),
                                          dtype=dtype, device=dev)
                          for _ in range(2))
                args = (ss.phi, torch.diagonal(ss.q, 0, -2, -1).contiguous(),
                        ss.z, ss.r, y, mask, bm, bc, sb, db)
                plain = ja.joint_adjoint_plain(*args, cs.ADJ_SEG, fac)
                exact = ja.joint_adjoint_plain(
                    *[a.double() if a.is_floating_point() else a
                      for a in args], cs.ADJ_SEG, fac)
                store[f"{str(dtype)[6:]}/{engine}"] = dict(
                    args=[a.cpu() for a in args], fac=fac,
                    plain=[p.cpu() for p in plain],
                    exact=[p.cpu() for p in exact])
        torch.save(store, store_path)
    acc = {}
    for key, d in torch.load(store_path).items():
        acc[key + "/plain_vs_exact"] = [rel(p, e) for p, e in
                                        zip(d["plain"], d["exact"])]
        args = [a.to(dev) for a in d["args"]]
        for b in (64, 16, 3):
            sub = [a[:b].contiguous() for a in args]
            g1 = ja.joint_adjoint(*sub, cs.ADJ_SEG, d["fac"])
            g2 = ja.joint_adjoint(*sub, cs.ADJ_SEG, d["fac"])
            acc[f"{key}/B{b}/vs_plain"] = [rel(g, p[:b]) for g, p in
                                           zip(g1, d["plain"])]
            acc[f"{key}/B{b}/vs_exact"] = [rel(g, p[:b]) for g, p in
                                           zip(g1, d["exact"])]
            acc[f"{key}/B{b}/deterministic"] = all(
                torch.equal(a, c) for a, c in zip(g1, g2))
    out["acc"] = acc

if "time" in jobs:
    ms = {}
    for dtype in (torch.float32, torch.float64):
        rng = np.random.default_rng(cs.SEED + 95)
        ss, y, mask = cs._adjoint_case(rng, cs.FLEET, cs.T_STEPS, dtype, dev)
        bm, bc, _ = cs._boundaries("joint", ss, y, mask, cs.ADJ_SEG)
        sb = torch.ones(y.shape[:2], dtype=dtype, device=dev)
        full = (ss.phi, torch.diagonal(ss.q, 0, -2, -1).contiguous(), ss.z,
                ss.r, y, mask, bm, bc, sb, sb)
        for b in ((512, 64, 8, 1) if dtype == torch.float32
                  else (512, 64, 1)):
            part = [a[:b].contiguous() for a in full]
            ms[f"{str(dtype)[6:]}/B{b}"] = cs.cuda_ms(
                lambda: ja.joint_adjoint_kernel(*part, cs.ADJ_SEG, False),
                reps=3, warm=1)[0]
        del full, ss, y, mask, bm, bc
        torch.cuda.empty_cache()
    out["ms"] = ms

if {"sqrt", "pert", "batch"} & set(jobs):
    rng = np.random.default_rng(cs.SEED + 30)  # chip_smoke's fit fleet
    y, mask, lds, _, _ = cs.make_workload(rng, cs.FLEET, t=cs.T_STEPS)
    y32 = y.astype(np.float32)
    names = [f"s{j}" for j in range(cs.N_SERIES)]

    def fleet_of(idx, dtype):
        vals = y32 if dtype == torch.float32 else y32.astype(np.float64)
        return pack_fleet([Panel(vals[i], mask[i], None, names,
                                 np.ones(cs.N_SERIES), np.zeros(cs.N_SERIES),
                                 1.0) for i in idx],
                          [lds[i] for i in idx], dtype=dtype, device=dev)

    fleet = fleet_of(range(cs.FLEET), torch.float32)
    p0 = autocorr_init_params(fleet)
    m = cs.SQRT_FIT_MODELS
    small = fleet_of(range(m), torch.float32)

    def grads(params, idx, engine):
        """The f32 gradient's error against the f64 one, per model."""
        v32, g32 = fleet_value_and_grad(params.float(),
                                        fleet_of(idx, torch.float32),
                                        engine=engine, grad="adjoint")
        v64, g64 = fleet_value_and_grad(params.double(),
                                        fleet_of(idx, torch.float64),
                                        engine=engine, grad="adjoint")
        per = ((g32.double() - g64).norm(dim=1) / g64.norm(dim=1)).cpu()
        return {"grad_rel_max": float(per.max()),
                "grad_rel_median": float(per.median()),
                "value_rel_max": float(((v32.double() - v64).abs()
                                        / v64.abs()).max())}

    def fit(data, start, **kw):
        reset_launches()
        with Sizes() as sz:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fit_fleet(data, p0=start, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        it = res.iterations.float()
        return res, {"wall_s": wall, "calls": len(sz.sizes),
                     "rows": sum(sz.sizes), "sizes": sz.sizes,
                     "launches": {k: v for k, v in launches().items() if v},
                     "iter_mean": float(it.mean()), "iter_max": int(it.max()),
                     "converged": float(res.converged.float().mean())}

    sqrt_kw = dict(engine="sqrt", grad_engine="adjoint", **cs.SQRT_FIT)
    if "sqrt" in jobs:
        res, row = fit(small, p0[:m], **sqrt_kw)
        row["grad_at_p0"] = grads(p0[:m], range(m), "sqrt")
        row["grad_at_fit"] = grads(res.params, range(m), "sqrt")
        out["sqrt_fit"] = row
    if "pert" in jobs:
        for name, kw in (("sqrt16", sqrt_kw), ("joint16", cs.BATCH_FIT)):
            rows = []
            for eps in eps_list:
                _, row = fit(small, p0[:m] * (1 + eps), **kw)
                rows.append({"eps": eps, **{k: row[k] for k in (
                    "wall_s", "calls", "rows", "iter_mean", "converged")}})
            out[f"pert_{name}"] = rows
    if "batch" in jobs:
        res, row = fit(fleet, p0, **cs.BATCH_FIT)
        idx = list(range(0, cs.FLEET, cs.FLEET // 16))
        row["grad_at_p0"] = grads(p0[idx], idx, "joint")
        row["grad_at_fit"] = grads(res.params[idx], idx, "joint")
        out["batch_fit"] = row
print("RESULT " + json.dumps(out), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--jobs", default="acc,time,sqrt,pert,batch")
    ap.add_argument("--eps", default="0,1e-6,-1e-6,3e-6")
    ap.add_argument("--compact", action="store_true")
    opt = ap.parse_args()
    here = Path(__file__).resolve().parents[1]
    trees = [here if d == "." else Path(d).resolve() for d in opt.dirs]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": smi.strip()}), flush=True)
    build = Path("metran_tpu_torch/kernels/build")
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "k11_plain.pt")
        for i, tree in enumerate(trees):
            if i and not (tree / build).exists() and (trees[0] / build).exists():
                shutil.copytree(trees[0] / build, tree / build)
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, opt.jobs,
                 "1" if opt.compact else "0", store, "1" if i == 0 else "0",
                 opt.eps], cwd=tree, capture_output=True, text=True,
                timeout=1800)
            line = [x for x in proc.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if not line:
                print(tree, "failed:", proc.stdout[-2000:],
                      proc.stderr[-3000:])
                return 1
            res = json.loads(line[0][len("RESULT "):])
            res.update(tree=str(tree), seconds=time.time() - t0)
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
